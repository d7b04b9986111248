"""Host ms per batch of update_data + solve() outside the IPM loop's
run_passes: equilibration, the stage-2 gather, post-processing, the copy
to the host and the solution objects.  Read from the batches timed
without the profiler on the host clock."""

from portbench.metrics._common import LOOP


def read(rec):
    plain = rec.get("plain")
    if not plain or LOOP not in plain["host_s"]:
        return None
    return ((sum(plain["batch_s"]) - plain["host_s"][LOOP]) * 1e3
            / plain["batches"])
