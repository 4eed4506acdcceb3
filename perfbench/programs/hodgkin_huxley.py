"""The program's problem for a configuration of the Hodgkin-Huxley
family: the port's ``HodgkinHuxleyProblem`` on the frozen graph, so no
pilot runs.

``Problem`` is the port's class as a user subclasses it: its
``evaluate_group`` returns the port's outputs unchanged and, while
``rows`` is a list, also keeps a reference to each (models, outputs)
pair that the sampling engine asked for, redraws included, in the order
it asked, so the check can judge the rows the timed path computed.
Under a mesh (``mesh``: ``"auto"`` for a sample mesh over the job that
the caller joined, as ``BLUEProblem`` takes it) each pair also carries
the stream of its chunk: the ``initial_seed()`` of the generator that
``sample_group`` last received, a host integer, so that rows evaluated
on any rank can be paired with the chunk they came from."""

from __future__ import annotations


def build(cfg: dict, datafile: str, seed: int, device: str, mesh=None):
    from bluest_tpu_torch.models.hodgkin_huxley import HodgkinHuxleyProblem

    class Problem(HodgkinHuxleyProblem):
        rows = None
        stream = None

        def sample_group(self, generator, ls, n):
            if self.mesh is not None:
                self.stream = generator.initial_seed()
            return super().sample_group(generator, ls, n)

        def evaluate_group(self, ls, params):
            out = super().evaluate_group(ls, params)
            if self.rows is not None:
                self.rows.append((tuple(ls), out) if self.mesh is None
                                 else (tuple(ls), out, self.stream))
            return out

    return Problem(
        models=tuple((int(k), float(dt)) for k, dt in cfg["models"]),
        datafile=datafile, device_batch_size=cfg["device_batch_size"],
        seed=int(seed), verbose=False, device=device, mesh=mesh)
