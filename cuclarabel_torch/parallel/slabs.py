"""A batch split into slabs over several devices, each slab solved by
its own host thread.

The data-parallel axis of `BatchSolver` and `BatchSparseSolver`
(n_devices > 1; reference parallel/batch.py:219-236): slab i of the
batch lives on device i, and every device runs an independent loop over
its slab and stops at its own slab's last iteration, with no collective.
The threads share one interpreter lock, which every torch call releases
and takes back, so their host work serialises: more cards do not yet
raise a batch's problems/s (PERF.md §6).
"""

import contextlib
import threading

import torch


def slab_bounds(B: int, n_devices: int) -> list:
    """[(lo, hi)] of n_devices equal slabs of B, in order; B must divide
    evenly."""
    if B % n_devices != 0:
        raise ValueError(
            f"batch size {B} must divide evenly across {n_devices} devices")
    w = B // n_devices
    return [(i * w, (i + 1) * w) for i in range(n_devices)]


def run_slabs(devices, jobs) -> list:
    """jobs[i]() on devices[i], all at once: one host thread per slab,
    inside torch.cuda.device(devices[i]) for the whole job where that is
    a card.  Returns the results in slab order; an exception in any
    thread is raised again here (the first in slab order)."""
    if len(jobs) == 1:
        return [jobs[0]()]
    results = [None] * len(jobs)
    errors = [None] * len(jobs)

    def work(i):
        ctx = (torch.cuda.device(devices[i]) if devices[i].type == "cuda"
               else contextlib.nullcontext())
        try:
            with ctx:
                results[i] = jobs[i]()
        except BaseException as exc:  # noqa: B036 - raised again below
            errors[i] = exc

    threads = [threading.Thread(target=work, args=(i,), daemon=True)
               for i in range(len(jobs))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for exc in errors:
        if exc is not None:
            raise exc
    return results
