"""Driver of ``kind: "prefill_hybrid"`` mixes: the ``prefill`` driver
(``drivers/prefill.py``: one client in a closed loop, one request at a
time, through ``launch.serve.generate(..., n_tokens=0)``) on a hybrid stack
whose layers each hold one mixer, Mamba-2 (M), MoE (E) or attention (*), as
Nemotron-H lays them out. Two things differ.

The weights. :func:`leaf_specs` lists the port's layout for the three layer
kinds, and :func:`make` draws it from the seed as ``weights.make`` draws a
decoder: leaves of one dtype are views of one buffer filled by ``normal_``
from a generator on the device, then scaled (matrices by 1/√fan_in, norm
scales, applied as 1 + w, by 0.1, the embedding by ``init["embed_std"]``,
the attention output by ``init["attn_out_gain"]``). With
``init["center_down_proj"]`` the matrices that take a non-negative-biased
input (each expert's and the shared expert's down projection, fed relu²,
and Mamba-2's out_proj, fed the SiLU-gated, normed y) are centred over
that input axis, so that they add no fixed direction to every token: with
random weights that direction would steer the later routers to the same
experts, where a trained model's routing stays near balanced. A Mamba-2 layer's
scalars are mapped from their normal draws u through Φ(u), uniform on
(0, 1): A = -exp(a_log) with a_log = log(1 + 15 Φ), dt_bias the inverse
softplus of a dt log-uniform on [1e-3, 0.1] (the release's initialisation),
D = 1 + 0.1 u; the conv weight takes 1/√W and its bias 0.1. These scalars,
the router and its correction bias are f32, as the port lays them out (the
serving step casts the scalars to bf16); the bias is drawn at
``init["router_bias_std"]``.

The check. With one MoE layer in two, a rule that left out every request
whose last token sits near a routing decision in any layer (``prefill.py``)
would leave out nearly all of them. Here every sampled request is compared:

  1. each sampled prompt is served again under ``moe.record_routing()``,
     and its logits must equal the kept ones bit for bit (``replay_diff``,
     the largest absolute difference; the program is deterministic);
  2. the plain f32 reference runs the prompt following the program's
     routing where they disagree at a near-tie: a token whose expert set
     differs takes the program's set where the reference's own margin (its
     k-th choice score less its (k+1)-th) is under ``NEAR``.
     ``route_misses`` counts the program's assignments the reference did
     not make beyond that margin, and the assignments both made whose kept
     or dropped state differs;
  3. ``route_departs`` is the share (%) of token-layer choices whose
     expert set differs from the reference's, forced or not. Rounding
     alone moves a fixed share of choices across near-ties; a router that
     departs systematically, but each time by less than ``NEAR`` (one that
     drops the correction bias, whose spread lies under ``NEAR``), moves
     many more, all of them forced, and is caught here;
  4. the logits are compared as ``prefill.py`` compares them:
     ``logit_err_max``, and ``token_misses`` with a ``CLEAR`` of its own
     (52 layers round more than four).

The control runs the reference in float8 in the program's place and holds
the float32 reference to its routing the same way.
"""
from __future__ import annotations

import math
import statistics
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch

from perfbench import spec, weights

prefill = spec.load_module(Path(__file__).resolve().parent / "prefill.py")

# A token's expert set may differ from the reference's where the
# reference's margin at its top-k boundary is under NEAR: 1.9 times the
# widest margin at which the program's routing departed from the
# reference's, 0.0314 over 12 seeds of 16 requests; the float8 control
# departs at margins up to 0.104-0.110 (PERF.md).
NEAR = 0.06
# A served token misses where the reference's logit of it lies more than
# CLEAR below the reference's best. Over 52 bf16 layers a logit departs by
# about 0.037 (the logit error's scale), so two near-equal top logits
# swap now and then: sound runs' largest gap is 0.078, CLEAR 2.55 times
# that; the control's swapped tokens lie 0.34-0.86 below (PERF.md).
CLEAR = 0.2
MAMBA_SCALARS = ("a_log", "dt_bias", "d_skip")
CENTRED = {"mlp.wo": 1, "shared.wo": 0, "mixer.out_proj": 0}  # a down projection and its input axis


def leaf_specs(cfg, init: Optional[Dict[str, float]] = None) -> List[Tuple[str, Tuple[int, ...], float, bool]]:
    """(name, shape, scale, f32 always) of every parameter of the hybrid
    stack, layer by layer; names as ``named_parameters()`` gives them."""
    init = init or {}
    d, h, kh, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    nh, hp, g, n, w = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_conv_width
    d_in = nh * hp
    conv_dim = d_in + 2 * g * n
    e, f, fs = cfg.n_experts, cfg.moe_d_ff, cfg.moe_shared_d_ff
    norm = weights.NORM_SCALE
    out = []
    for i in range(cfg.n_layers):
        p = f"layers.{i}."
        kind = cfg.block_kinds[i % len(cfg.block_kinds)]
        if kind == "mamba":
            out += [(p + "norm1", (d,), norm, False),
                    (p + "mixer.in_proj", (d, d_in + conv_dim + nh), 1 / math.sqrt(d), False),
                    (p + "mixer.conv_w", (w, conv_dim), 1 / math.sqrt(w), False),
                    (p + "mixer.conv_b", (conv_dim,), 0.1, False),
                    (p + "mixer.a_log", (nh,), 1.0, True),
                    (p + "mixer.d_skip", (nh,), 0.1, True),
                    (p + "mixer.dt_bias", (nh,), 1.0, True),
                    (p + "mixer.norm", (d_in,), norm, False),
                    (p + "mixer.out_proj", (d_in, d), 1 / math.sqrt(d_in), False)]
        elif kind == "attn":
            out += [(p + "norm1", (d,), norm, False),
                    (p + "mixer.wq", (d, h * dh), 1 / math.sqrt(d), False),
                    (p + "mixer.wk", (d, kh * dh), 1 / math.sqrt(d), False),
                    (p + "mixer.wv", (d, kh * dh), 1 / math.sqrt(d), False),
                    (p + "mixer.wo", (h * dh, d), init.get("attn_out_gain", 1.0) / math.sqrt(h * dh), False)]
        if cfg.mlp_kinds[i % len(cfg.mlp_kinds)] == "moe":
            out += [(p + "norm2", (d,), norm, False),
                    (p + "mlp.router", (d, e), 1 / math.sqrt(d), True),
                    (p + "mlp.router_bias", (e,), init.get("router_bias_std", 0.0), True),
                    (p + "mlp.wi_up", (e, d, f), 1 / math.sqrt(d), False),
                    (p + "mlp.wo", (e, f, d), 1 / math.sqrt(f), False),
                    (p + "mlp.shared.wi_up", (d, fs), 1 / math.sqrt(d), False),
                    (p + "mlp.shared.wo", (fs, d), 1 / math.sqrt(fs), False)]
    out.append(("final_norm", (d,), norm, False))
    out.append(("embed", (cfg.vocab_size, d), init.get("embed_std", 0.02), False))
    out.append(("lm_head", (d, cfg.vocab_size), 1 / math.sqrt(d), False))
    return out


def _mamba_scalar(kind: str, u: torch.Tensor) -> torch.Tensor:
    """A Mamba-2 scalar from its normal draw u (module docstring)."""
    uf = u.float()
    phi = 0.5 * (1.0 + torch.erf(uf / math.sqrt(2.0)))  # uniform on (0, 1)
    if kind == "a_log":
        return torch.log(1.0 + 15.0 * phi)
    if kind == "dt_bias":
        dt = torch.exp(math.log(1e-3) + phi * (math.log(0.1) - math.log(1e-3))).clamp_min(1e-4)
        return dt + torch.log(-torch.expm1(-dt))
    return 1.0 + 0.1 * uf  # d_skip


def make(cfg, seed: int, dtype: torch.dtype, device, init: Optional[Dict[str, float]] = None) -> Dict[str, Any]:
    """The hybrid stack's weights drawn from ``seed`` (module docstring), as
    the port's nested dict."""
    specs = leaf_specs(cfg, init)
    flat: Dict[str, torch.Tensor] = {}
    for want_f32 in (False, True):
        mine = [s for s in specs if s[3] == want_f32]
        dt = torch.float32 if want_f32 else dtype
        total = sum(math.prod(s[1]) for s in mine)
        buf = torch.empty(total, dtype=dt, device=device)
        gen = weights.generator(device, seed, "weights", dt)
        for start in range(0, total, weights.CHUNK):
            buf[start:start + weights.CHUNK].normal_(generator=gen)
        off = 0
        for name, shape, scale, _ in mine:
            size = math.prod(shape)
            leaf = buf[off:off + size].view(shape)
            kind = name.rsplit(".", 1)[-1]
            if kind in MAMBA_SCALARS:
                leaf.copy_(_mamba_scalar(kind, leaf))
            else:
                leaf.mul_(scale)
            axis = CENTRED.get(".".join(name.split(".")[-2:]))
            if axis is not None and (init or {}).get("center_down_proj"):
                leaf.sub_(leaf.mean(axis, keepdim=True, dtype=torch.float32).to(leaf.dtype))
            flat[name] = leaf
            off += size
    return weights.nest({name: flat[name] for name, *_ in specs})


class Driver(prefill.Driver):
    def draw_weights(self):
        return make(self.cfg, self.seed, torch.bfloat16, self.dev, self.cell.config.get("init"))

    def setup(self):
        from repro_torch.models.model import Model, RunFlags

        self.weights = self.draw_weights()
        self.model = Model(self.weights)
        self.flags = RunFlags(attn_impl=self.mix["attn_impl"], norm_impl=self.mix["norm_impl"],
                              ssd_impl=self.mix["ssd_impl"], ssd_chunk=self.mix["ssd_chunk"])
        for i in range(self.mix["warmup_requests"]):
            self.serve(self.prompt("warmup", i))
        k = self.mix["check_requests"]
        self.sample = torch.empty((k, self.mix["batch"], self.cfg.vocab_size), dtype=torch.float32, device=self.dev)
        self.sample_of = [None] * k

    def check(self) -> dict:
        """Every sampled request served again under the routing record,
        then against the plain f32 reference that follows its near-ties
        (module docstring)."""
        from repro_torch.models import moe
        from repro_torch.models.model import Model

        ref = self.cell.reference()
        self.model = Model(self.weights)
        rows, replay = [], 0.0
        for slot, kept in enumerate(self.sample_of):
            if kept is None:
                continue
            i, first = kept
            prompt = self.prompt("request", i)
            with moe.record_routing() as calls:
                _, logits = self.serve(prompt)
            replay = max(replay, (logits - self.sample[slot]).abs().max().item())
            follow = [{"expert_idx": c["expert_idx"], "keep": c["keep"]} for c in calls]
            rows += self._compare(ref, self.weights, prompt, self.sample[slot], first, follow)
        self.model = None
        return dict(self._numbers(rows), replay_diff=replay)

    def control(self) -> dict:
        """The plain reference in float8 in the program's place, against
        itself in float32 following the float8 routing's near-ties, on the
        first ``check_requests`` prompts of this seed."""
        ref = self.cell.reference()
        w = self.draw_weights()
        rows = []
        for i in range(self.mix["check_requests"]):
            prompt, stats = self.prompt("request", i), []
            with ref.reference_precision():
                got = ref.last_logits(w, self.cfg, prompt, fp8=True, stats=stats)
            follow = [s["route"] for s in stats]
            del stats
            rows += self._compare(ref, w, prompt, got, got.argmax(-1).tolist(), follow)
        return self._numbers(rows)

    def _compare(self, ref, w, prompt, got, first, follow) -> list:
        """(served logits, served token, reference logits, the reference's
        routing statistics) of each row of one prompt."""
        stats = []
        with ref.reference_precision():
            want = ref.last_logits(w, self.cfg, prompt, stats=stats, follow=follow, near=NEAR)
        for s in stats:
            del s["route"]
        self.details.setdefault("drop_share", []).append([s["drop_share"] for s in stats])
        return [(got[r], tok, want[r], stats) for r, tok in enumerate(first)]

    def _numbers(self, rows) -> dict:
        """Over every sampled row: ``logit_err_max``, the worst
        ‖l − l_ref‖ / ‖l_ref − mean(l_ref)‖; ``token_misses``, the rows
        whose served token's reference logit lies more than ``CLEAR`` below
        the reference's best; ``route_misses``, summed over the rows'
        prompts and their MoE layers; ``route_departs``, the share (%) of
        their token-layer choices whose expert set differed from the
        reference's. ``details`` keeps each row's error
        and gap, each layer's drop share, and per layer the tokens forced
        to the program's experts and the widest margin of a departure."""
        errs = [prefill.rel_err(got, want) for got, _, want, _ in rows]
        gaps = [(want.max() - want[tok]).item() for _, tok, want, _ in rows]
        stats = [s for *_, s in rows]
        drops = self.details.get("drop_share", [])
        self.details.update(
            logit_err=errs, gap=gaps,
            forced=[[s["forced"] for s in st] for st in stats],
            forced_margin_max=[max((s["forced_margin_max"] for s in st), default=0.0) for st in stats],
            drop_share_by_layer=[statistics.mean(c) for c in zip(*drops)] if drops else [])
        per_prompt = {id(st): st for st in stats}.values()  # the rows of one prompt share its statistics
        layers = [s for st in per_prompt for s in st]
        misses = sum(s["set_misses"] + s["keep_misses"] for s in layers)
        choices = sum(s["tokens"] for s in layers)
        return {"logit_err_max": max(errs, default=float("inf")),
                "token_misses": float(sum(g > CLEAR for g in gaps)),
                "route_misses": float(misses),
                "route_departs": 100.0 * sum(s["departs"] for s in layers) / choices if choices else float("inf")}

    def notes(self) -> dict:
        """The sampled rows (all compared), the largest gap of a served
        token, each MoE layer's share of assignments dropped, the tokens
        forced to the program's experts a request, and the widest margin at
        which the program departed."""
        d = self.details
        return {"rows_sampled": len(d.get("logit_err", [])), "rows_compared": len(d.get("logit_err", [])),
                "gap_max": max(d.get("gap", []), default=0.0),
                "drop_share_by_layer": d.get("drop_share_by_layer", []),
                "forced_a_request": [sum(f) for f in d.get("forced", [])],
                "forced_margin_max": max(d.get("forced_margin_max", []), default=0.0)}
