"""The port's checkpoint manager, Supervisor and training launcher on the
CPU, mirroring ``tests/test_checkpoint_runtime.py``: the on-disk contract
(``step_%08d/meta.json`` + ``arr_<key>.npy``, committed by rename), keep-N,
async saves whose host copy is taken at ``save``, restore onto the target's
device and dtype; recovery from an injected fault to the uninterrupted run
(bit for bit: the same CPU arithmetic), and the step's own error when no
checkpoint exists; ``launch.train.main`` in-process, with ``--resume``."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.manager import CheckpointManager as RefManager  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs.registry import reduced_config  # noqa: E402
from repro_torch.data.pipeline import for_model  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.model import Model, RunFlags  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.runtime.health import Supervisor  # noqa: E402
from repro_torch.train.step import init_train_state, make_train_step  # noqa: E402


def tiny_state(seed=0):
    g = torch.Generator().manual_seed(seed)
    model = Model({"layers": [{"norm1": torch.zeros(4)}], "final_norm": torch.randn(4, generator=g),
                   "embed": torch.randn(8, 4, generator=g)}).requires_grad_(True)
    return {"params": model,
            "opt": {"m": {"embed": torch.randn(8, 4, generator=g)}, "count": torch.tensor(3, dtype=torch.int32)},
            "half": torch.randn(3, 5, generator=g).to(torch.bfloat16),
            "step": torch.tensor(7, dtype=torch.int32)}


def leaves(state):
    out = {"params." + n: p.detach() for n, p in state["params"].named_parameters()}
    out.update({"opt.m.embed": state["opt"]["m"]["embed"], "opt.count": state["opt"]["count"],
                "half": state["half"], "step": state["step"]})
    return out


def test_checkpoint_roundtrip(tmp_path):
    m = CheckpointManager(str(tmp_path), async_save=False)
    state = tiny_state()
    m.save(7, state, extra={"data_step": 9})
    restored, meta = m.restore(tiny_state(seed=1))
    assert meta["step"] == 7 and meta["extra"]["data_step"] == 9
    assert isinstance(restored["params"], Model)
    assert all(p.requires_grad for p in restored["params"].parameters())
    want, got = leaves(state), leaves(restored)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_checkpoint_on_disk_layout_is_the_reference_contract(tmp_path):
    """meta.json and one arr_<key>.npy per leaf under step_%08d, readable
    with numpy alone; the reference's manager lists the same steps."""
    m = CheckpointManager(str(tmp_path), async_save=False)
    m.save(12, tiny_state())
    d = tmp_path / "step_00000012"
    with open(d / "meta.json") as f:
        meta = json.load(f)
    keys = {leaf["key"] for leaf in meta["leaves"]}
    assert keys == set(leaves(tiny_state()))
    assert sorted(os.listdir(d)) == sorted(["meta.json"] + [f"arr_{k}.npy" for k in keys])
    assert np.load(d / "arr_params.embed.npy").shape == (8, 4)
    assert {leaf["key"]: leaf["dtype"] for leaf in meta["leaves"]}["half"] == "bfloat16"
    assert RefManager(str(tmp_path)).all_steps() == m.all_steps() == [12]


def test_restore_casts_to_the_target_dtype_and_device(tmp_path):
    m = CheckpointManager(str(tmp_path), async_save=False)
    state = tiny_state()
    m.save(1, state)
    target = dict(tiny_state(), half=torch.zeros(3, 5, dtype=torch.float32))
    restored, _ = m.restore(target, device="cpu")
    assert restored["half"].dtype == torch.float32
    assert torch.equal(restored["half"], state["half"].float())
    with pytest.raises(ValueError, match="shape"):
        m.restore(dict(tiny_state(), half=torch.zeros(2, 2)))


def test_checkpoint_atomic_ignores_partial(tmp_path):
    m = CheckpointManager(str(tmp_path), async_save=False)
    m.save(1, tiny_state())
    # a crash mid-save: a stray tmp dir and a committed dir missing its meta
    os.makedirs(tmp_path / ".tmp-step_00000002")
    os.makedirs(tmp_path / "step_00000003")
    assert m.latest_step() == 1
    restored, meta = m.restore(tiny_state(seed=2))
    assert meta["step"] == 1


def test_checkpoint_keep_n(tmp_path):
    m = CheckpointManager(str(tmp_path), keep_n=2, async_save=False)
    for s in (1, 2, 3, 4):
        m.save(s, tiny_state())
    assert m.all_steps() == [3, 4]


def test_checkpoint_async_copies_at_save(tmp_path):
    """The host copy is taken at ``save``: the state changed in place right
    after (as the train step changes it) does not reach the files."""
    m = CheckpointManager(str(tmp_path), async_save=True)
    state = tiny_state()
    want = leaves(state)["opt.m.embed"].clone()
    m.save(5, state)
    state["opt"]["m"]["embed"].add_(1.0)
    m.wait()
    assert m.latest_step() == 5
    restored, _ = m.restore(tiny_state())
    assert torch.equal(restored["opt"]["m"]["embed"], want)


def test_checkpoint_restore_without_checkpoints_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path)).restore(tiny_state())


# ---------------------------------------------------------------------------
# supervisor
# ---------------------------------------------------------------------------
def supervised_run(tmp_path, name, fail_at=None, n_steps=8):
    cfg = reduced_config("qwen3-1.7b")
    opt = AdamWConfig(peak_lr=1e-3, warmup_steps=2, total_steps=20)
    raw = make_train_step(cfg, RunFlags(attn_impl="kernel", norm_impl="kernel", remat="full"), opt)
    data = for_model(cfg, seq_len=16, global_batch=4, seed=0)
    ckpt = CheckpointManager(str(tmp_path / name), keep_n=3, async_save=True)
    state = init_train_state(cfg, seed=0, device="cpu")
    target, calls, losses = state, {"n": 0}, {}

    def flaky(s, b):
        calls["n"] += 1
        if calls["n"] == fail_at:
            raise RuntimeError("injected device failure")
        return raw(s, b)

    sup = Supervisor(ckpt, data, save_every=3)
    out = sup.run(state, flaky, n_steps, restore_fn=lambda: ckpt.restore(target),
                  on_metrics=lambda i, m: losses.__setitem__(i, m["loss"].item()))
    return out, sup, losses


def test_supervisor_recovers_and_matches_uninterrupted_run(tmp_path):
    ref, _, ref_losses = supervised_run(tmp_path, "ref")
    out, sup, losses = supervised_run(tmp_path, "faulty", fail_at=6)
    assert sup.recoveries == 1
    assert sorted(losses) == list(range(1, 9)) and losses == ref_losses  # replayed steps overwrite
    for (n, a), (_, b) in zip(ref["params"].named_parameters(), out["params"].named_parameters()):
        assert torch.equal(a, b), n
    assert int(out["step"]) == 8


def test_supervisor_reraises_the_step_error_without_a_checkpoint(tmp_path):
    """A step that fails before the first save has nothing to restore: the
    step's own error surfaces, the missing checkpoint on its cause."""
    with pytest.raises(RuntimeError, match="injected device failure") as info:
        supervised_run(tmp_path, "early", fail_at=2)
    assert isinstance(info.value.__cause__, FileNotFoundError)


# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------
def test_launch_train_main_in_process(tmp_path, capsys):
    args = ["--arch", "qwen3-1.7b", "--reduced", "--device", "cpu", "--seq-len", "32",
            "--global-batch", "4", "--save-every", "3", "--ckpt-dir", str(tmp_path / "ck")]
    out = launch_train.main(args + ["--steps", "6", "--attn-impl", "kernel", "--norm-impl", "kernel"])
    assert len(out["losses"]) == 6 and np.isfinite(out["losses"]).all() and out["recoveries"] == 0
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_00000003", "step_00000006"]
    resumed = launch_train.main(args + ["--steps", "8", "--resume"])
    assert "resumed from step 6" in capsys.readouterr().out
    assert len(resumed["losses"]) == 2  # steps 7 and 8


def test_launch_train_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default is taken")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_train.main(["--reduced", "--steps", "1"])


def test_chip_smoke_train_phase_rehearses_on_the_cpu(capsys):
    """``chip_smoke.train_phase`` at a reduced size on the CPU (the kernels'
    plain versions, no launches to count): the card-vs-plain step, the two
    supervised runs and the recovered trace's bitwise check all hold."""
    import dataclasses
    import json

    import chip_smoke

    cfg = dataclasses.replace(reduced_config("qwen3-1.7b"), n_layers=2)
    launches = chip_smoke.train_phase("cpu", cfg, device="cpu", seq=32, batch=4)
    assert launches["flash"] == launches["rmsnorm"] == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "train" and line["ok"] and line["recovery"]["recoveries"] == 1
    assert line["recovery"]["bitwise_equal_steps"] == line["steps"] == 8


def test_chip_smoke_train_moe_phase_rehearses_on_the_cpu(capsys):
    """``chip_smoke.train_moe_phase`` at a reduced size on the CPU (reduced
    Qwen3-MoE, one layer, 8 experts, compared at 4; the kernels' plain
    versions, no launches to count, no sync check): the step loop, the
    kernel-vs-plain step with its routing flips and the FLOP accounting
    hold, and the losses fall."""
    import dataclasses
    import json

    import chip_smoke

    cfg = dataclasses.replace(reduced_config("qwen3-moe-235b-a22b"), n_layers=1, n_experts=8)
    launches = chip_smoke.train_moe_phase("cpu", cfg, device="cpu", seq=32, batch=4, compare_experts=4, lr=5e-3)
    assert launches["flash"] == launches["rmsnorm"] == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "train_moe" and line["ok"] and len(line["losses"]) == line["steps"] == 6
    assert (line["experts"], line["capacity"]) == (8, 40)
    assert (line["vs_plain"]["experts"], line["vs_plain"]["capacity"]) == (4, 80)
    assert line["vs_plain"]["routing_flips"][0]["set"] <= 0.05
    assert line["model_flops_with_recompute"] == line["model_flops_per_step"] * 4 / 3 > 0
    # the untied embedding's lookup, 6 · V · D · tokens of the count, reported apart
    assert line["embed_lookup_flops"] == 6 * cfg.vocab_size * cfg.d_model * 4 * 32
    assert line["mfu_without_embed_lookup"] < line["mfu"]
    # the gradients held leaf by leaf (through the first moments), experts and router included
    grads = line["vs_plain"]["grads_by_kind"]
    assert {"mixer.wq", "mlp.router", "mlp.wi_gate", "mlp.wo", "embed", "lm_head"} <= set(grads)
    assert line["vs_plain"]["grad_rel_norm_worst"]["value"] <= chip_smoke.TRAIN_GRAD_RTOL
