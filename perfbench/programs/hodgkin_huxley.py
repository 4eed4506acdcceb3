"""The program's problem for a configuration of the Hodgkin-Huxley
family: the port's ``HodgkinHuxleyProblem`` on the frozen graph, so no
pilot runs.

``Problem`` is the port's class as a user subclasses it: its
``evaluate_group`` returns the port's outputs unchanged and, while
``rows`` is a list, also keeps a reference to each (models, outputs)
pair that the sampling engine asked for, redraws included, in the order
it asked, so the check can judge the rows the timed path computed."""

from __future__ import annotations


def build(cfg: dict, datafile: str, seed: int, device: str):
    from bluest_tpu_torch.models.hodgkin_huxley import HodgkinHuxleyProblem

    class Problem(HodgkinHuxleyProblem):
        rows = None

        def evaluate_group(self, ls, params):
            out = super().evaluate_group(ls, params)
            if self.rows is not None:
                self.rows.append((tuple(ls), out))
            return out

    return Problem(
        models=tuple((int(k), float(dt)) for k, dt in cfg["models"]),
        datafile=datafile, device_batch_size=cfg["device_batch_size"],
        seed=int(seed), verbose=False, device=device)
