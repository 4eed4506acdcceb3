"""estimate_s (host clock): the window's wall over the estimates
completed in it."""


def read(run):
    if run["cell"]["kind"] != "estimate":
        return None
    n = sum(r["ok"] for r in run["requests"])
    return run["window_s"] / n if n else None
