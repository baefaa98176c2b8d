"""``ssd_roofline.prefill_hybrid``: the port's SSD entry
(``kernels.ssd.ops.ssd``, as a Mamba-2 prefill calls it: x, B and C bf16
views of one projection, dt f32) timed alone with CUDA events at the cell's
shape (the prompt's tokens, the configuration's heads, head dim, groups and
state, the mix's chunk), against its roofline bound: the larger of its
FLOPs over the bf16 peak and its bytes (x, dt, B, C and y once each, the
final state once) over HBM bandwidth (``flops_hybrid.ssd_cost``). The share
is the bound over the time."""
from perfbench import flops, flops_hybrid, weights
from perfbench.devtrace import cuda_time_s

REPS = 50


def read(run):
    if run.device.type != "cuda" or run.cell.mix["kind"] != "prefill_hybrid":
        return None
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.ssd.ops import ssd

    cfg, mix = run.cfg, run.cell.mix
    b, s, q = mix["batch"], mix["prompt_len"], mix["ssd_chunk"]
    h, p, g, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups, cfg.ssm_state
    gen = weights.generator(run.device, run.driver.seed, "ssd_probe")
    xbc = torch.randn((b, s, h * p + 2 * g * n), generator=gen, device=run.device).to(torch.bfloat16)
    x = xbc[..., :h * p].view(b, s, h, p)
    bm = xbc[..., h * p:h * p + g * n].unflatten(-1, (g, n))
    cm = xbc[..., h * p + g * n:].unflatten(-1, (g, n))
    dt = F.softplus(torch.randn((b, s, h), generator=gen, device=run.device) - 4.0)
    a = -torch.exp(torch.rand((h,), generator=gen, device=run.device) * 2.7)
    with torch.inference_mode():
        seconds = cuda_time_s(lambda: ssd(x, dt, a, bm, cm, chunk=q), REPS)
    bound, _ = flops.roofline_s(*flops_hybrid.ssd_cost(b, s, h, p, n, g, q))
    return 100.0 * bound / seconds
