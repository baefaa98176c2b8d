"""The share of the hybrid prefill cell's traced window in which nothing ran
on the device (the union of every device activity's interval, from the
profiler's trace), as ``device_idle.prefill`` reads it."""


def read(run):
    t = run.trace
    if run.cell.mix["kind"] != "prefill_hybrid" or not t or t.get("window_s", 0) <= 0 or not t.get("n_device_ops"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
