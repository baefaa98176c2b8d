"""``prefill_mfu.hybrid``: the FLOPs the window's prefills of the hybrid
stack need (``flops_hybrid.prefill_request_flops``: 2 · non-embedding
active parameters · tokens, the attention layers' causal products, the SSD's
chunked products, the head on the last position) over the window's seconds,
as a share of one H100's bf16 peak."""
from perfbench import flops, flops_hybrid


def read(run):
    if run.cell.mix["kind"] != "prefill_hybrid" or not run.window.attempted:
        return None
    mix = run.cell.mix
    per_request = flops_hybrid.prefill_request_flops(run.cfg, mix["batch"], mix["prompt_len"], mix["ssd_chunk"])
    return 100.0 * per_request * run.window.attempted / run.window.seconds / flops.PEAK_BF16_FLOPS
