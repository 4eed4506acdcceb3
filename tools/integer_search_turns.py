"""The allocation's integer corner search alone, this tree's
``bluest_tpu_torch/solvers/integer.py`` and another in turns, on the card.

    python tools/integer_search_turns.py OTHER_INTEGER_PY

OTHER_INTEGER_PY is another version of that module (for example
``git show REV:bluest_tpu_torch/solvers/integer.py`` written out under
``build/``), loaded as a module of this package.  The script builds the
flagship as ``chip_smoke.py``'s phase 4 does (its timed solves left
out), makes one host set-up of each of phase 11's flagship programs, (a)
at the calibrated budget and (b) at eps*, and records the arguments of
their ``best_integer_blue_multi`` calls.  From that one continuous point
it runs each module's searches: once to warm; once on the card under
cProfile, its wall split into uploads, eigensolve calls, reads and host
bookkeeping (the rest); once on the host (the same samples as the card's
or not, the chosen corners' max-variance gap); once under
``torch.cuda.set_sync_debug_mode("warn")`` (the synchronising calls by
site); then the card walls and the host walls in turns (other, this,
this, other).  Each program gives one JSON line.  It needs one card.
"""

import cProfile
import importlib.util
import json
import os
import pstats
import sys
import tempfile
import warnings

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as c  # noqa: E402


def other_integer(path):
    """The module at ``path``, loaded as a module of this package (its
    relative imports resolve here)."""
    spec = importlib.util.spec_from_file_location(
        "bluest_tpu_torch.solvers._integer_other", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def profiled_split(mod, calls):
    """One card run of the searches under cProfile: its wall split into
    uploads, eigensolve calls, reads and host bookkeeping (s).  A module
    with the dispatch wrappers is split by them (``_upload``, ``pinv00``,
    cumulative); one without by its torch calls' own time
    (``torch.as_tensor``, ``linalg_eigh``).  Reads are ``Tensor.cpu``'s
    own time.  A call that makes the host wait holds the card's work
    queued before it."""
    prof = cProfile.Profile()
    prof.enable()
    _, wall = c._searches(mod, c.DEV, calls)
    prof.disable()
    t = {}
    for (_, _, fn), (_, _, tt, ct, _) in pstats.Stats(prof).stats.items():
        for key, name in (("upload", "_upload"), ("pinv00", "pinv00")):
            if fn == name:
                t[key] = t.get(key, 0.0) + ct
        for key, name in (("as_tensor", "torch.as_tensor"),
                          ("eigh", "linalg_eigh"), ("cpu", "'cpu'")):
            if name in fn:
                t[key] = t.get(key, 0.0) + tt
    split = {"uploads": t.get("upload", t.get("as_tensor", 0.0)),
             "eigensolves": t.get("pinv00", t.get("eigh", 0.0)),
             "reads": t.get("cpu", 0.0)}
    split["host"] = wall - sum(split.values())
    split["wall"] = wall
    return split


def sync_sites(mod, calls):
    """The synchronising calls of ``mod``'s searches on the card, by call
    site."""
    import torch
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            c._searches(mod, c.DEV, calls)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sites = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            site = "%s:%d" % (os.path.relpath(w.filename), w.lineno)
            sites[site] = sites.get(site, 0) + 1
    return sites


def main():
    from bluest_tpu_torch.solvers import integer
    mods = {"other": other_integer(sys.argv[1]), "this": integer}
    name, smi = c.phase_device()
    c.phase_build()
    c._both_paths = lambda *a, **k: None    # phase 4's timed solves
    with tempfile.TemporaryDirectory() as d:
        graph = os.path.join(d, "flagship_graph.npz")
        f = c.phase_flagship(smi, graph)
        fp = c._flagship_from_graph(graph)
        programs = (("(a) flagship budget", dict(K=c.K, budget=f["budget"])),
                    ("(b) flagship eps*", dict(K=c.K, eps=f["eps_star"])))
        for program, how in programs:
            calls = c._cold_setup(fp, "host", how)["searches"]
            rec = {}
            for key, mod in mods.items():
                c._searches(mod, c.DEV, calls)          # warm
                split = profiled_split(mod, calls)
                card = c._searches(mod, c.DEV, calls)[0]
                host = c._searches(mod, "cpu", calls)[0]
                same, dv = c._same_results(card, host)
                sites = sync_sites(mod, calls)
                rec[key] = {"same_samples_card_host": same,
                            "maxvar_rel_diff_card_host": dv,
                            "split_s": split,
                            "syncs": sum(sites.values()), "sites": sites,
                            "walls_s": [], "host_walls_s": []}
            order = ("other", "this", "this", "other")
            for key in order:
                rec[key]["walls_s"].append(
                    c._searches(mods[key], c.DEV, calls)[1])
            for key in order:
                rec[key]["host_walls_s"].append(
                    c._searches(mods[key], "cpu", calls)[1])
            print(json.dumps({"program": program, "calls": len(calls),
                              "card": name, "smi": smi, "order": order,
                              "modules": rec}, sort_keys=True), flush=True)


if __name__ == "__main__":
    main()
