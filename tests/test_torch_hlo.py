"""The port's collective accounting (``repro_torch.roofline.hlo``) on a fake
4-device mesh, in-process, on CPU and on meta tensors:

- the counter sees DTensor's own collectives, the implicit ones inside an
  op's dispatch included: ``x @ w`` with both operands ``Shard(0)`` gathers
  w (one all-gather of 2,048 bytes), where a mode that runs DTensor ops
  itself sees none; an explicit ``Shard(0)`` → ``Replicate()`` of x is one
  all-gather of 8,192 bytes; funcol's all-reduce, reduce-scatter and
  all-to-all land in their categories, and ``wait_tensor`` and
  ``_wrap_tensor_autograd`` are not counted;
- the categories and keys are the reference's (``repro.roofline.hlo``);
- each collective is filed under its issuer (``collective_bytes_by_op``);
- the step's parts: each microbatch's forward and backward and the update;
- flops by ``torch.utils.flop_counter``'s formulas, on the local shards;
- live bytes: a storage counts from its first op to its release, views
  add nothing, held arguments count nothing, and DTensor's sharding
  propagation (fake tensors of the global shape) counts nothing;
- the flash wrapper's meta calls are read as kernel calls.

The fake process group moves nothing: only shapes, placements and counts
are held here, never values.
"""
import pytest

torch = pytest.importorskip("torch")

import torch.distributed._functional_collectives as funcol  # noqa: E402
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate, Shard  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.roofline import hlo as RH  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.launch.dryrun import fake_world  # noqa: E402
from repro_torch.roofline import hlo as H  # noqa: E402

DEVICES = ("cpu", "meta")


@pytest.fixture
def mesh():
    with fake_world(4):
        yield init_device_mesh("cpu", (4,))


def sharded(mesh, shape, device, requires_grad=False):
    """A ``Shard(0)`` DTensor of global ``shape`` (f32) over the 4 devices."""
    local = torch.zeros((shape[0] // 4,) + tuple(shape[1:]), device=device, requires_grad=requires_grad)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, [Shard(0)], run_check=False, shape=shape, stride=stride)


def only(counts, kind):
    assert all(n == 0 for c, n in counts.items() if c != kind), counts
    return counts[kind]


@pytest.mark.parametrize("device", DEVICES)
def test_implicit_gather_of_a_matmul_operand(mesh, device):
    x, w = sharded(mesh, (64, 32), device), sharded(mesh, (32, 16), device)
    with H.StepCounter() as c:
        y = x @ w
    assert y.placements == (Shard(0),)
    b = H.collective_bytes(c)
    assert only(H.collective_counts(c), "all-gather") == 1
    assert b["all-gather"] == 32 * 16 * 4 == 2048 and b["total"] == 2048 and b["count"] == 1
    assert c.totals()["flops"] == 2 * 16 * 32 * 16  # the local (16, 32) @ (32, 16)


@pytest.mark.parametrize("device", DEVICES)
def test_a_mode_that_runs_dtensor_ops_itself_misses_the_implicit_gather(mesh, device):
    """What the counter avoids by returning ``NotImplemented`` on DTensor
    types: the mode below runs each op itself, so DTensor dispatches the
    matmul without it and its gather goes unseen."""

    class RunsItself(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen.append(str(func))
            return func(*args, **(kwargs or {}))

    x, w = sharded(mesh, (64, 32), device), sharded(mesh, (32, 16), device)
    with RunsItself() as m:
        x @ w
    assert m.seen and not [s for s in m.seen if "c10d" in s], m.seen


@pytest.mark.parametrize("device", DEVICES)
def test_collectives_are_filed_under_their_issuer(mesh, device):
    """``collective_bytes_by_op``: the gather inside the matmul's dispatch
    under ``aten.mm.default``, an explicit redistribution under
    ``redistribute``, a functional collective called directly under its own
    name; the issuers' bytes sum to the totals (this file is no port code,
    so no port function is named)."""
    x, w = sharded(mesh, (64, 32), device), sharded(mesh, (32, 16), device)
    with H.StepCounter() as c:
        x @ w
        x.redistribute(mesh, [Replicate()])
        funcol.all_reduce(torch.ones(4, device=device), "sum", mesh)
    by = H.collective_bytes_by_op(c)
    assert {k.split(" @ ")[0]: v["bytes"] for k, v in by.items()} == {
        "redistribute": 8192, "aten.mm.default": 2048, "_c10d_functional::all_reduce": 16}
    assert list(by.values())[0]["bytes"] == 8192  # the most bytes first
    assert sum(v["bytes"] for v in by.values()) == H.collective_bytes(c)["total"]


@pytest.mark.parametrize("device", DEVICES)
def test_explicit_redistribute_is_one_all_gather(mesh, device):
    x = sharded(mesh, (64, 32), device)
    with H.StepCounter() as c:
        z = x.redistribute(mesh, [Replicate()])
        z.to_local() + 1
    assert only(H.collective_counts(c), "all-gather") == 1
    assert H.collective_bytes(c)["all-gather"] == 64 * 32 * 4 == 8192


@pytest.mark.parametrize("device", DEVICES)
def test_funcol_collectives_land_in_their_categories(mesh, device):
    t = torch.zeros(16, 32, device=device, requires_grad=True)
    with H.StepCounter() as c:
        a = funcol.all_reduce(t, "sum", mesh)
        r = funcol.reduce_scatter_tensor(t.detach(), "sum", 0, mesh)
        x = funcol.all_to_all_single_autograd(t, None, None, mesh)
        (a + 1, r + 1, x + 1)
    b, n = H.collective_bytes(c), H.collective_counts(c)
    assert (b["all-reduce"], b["reduce-scatter"], b["all-to-all"]) == (2048, 512, 2048)
    assert n == {"all-gather": 0, "all-reduce": 1, "reduce-scatter": 1, "all-to-all": 1,
                 "collective-permute": 0}
    assert b["count"] == 3 and b["total"] == 2048 + 512 + 2048
    assert all("wait_tensor" not in op and "_wrap_tensor" not in op for op in c.ops), c.ops
    assert sum(c.ops.values()) == 3


def test_categories_and_keys_are_the_references():
    assert H.COLLECTIVES == RH.COLLECTIVES
    with H.StepCounter() as c:
        pass
    assert H.collective_bytes(c) == RH.collective_bytes("")
    assert set(H.collective_counts(c)) == set(RH.COLLECTIVES)


@pytest.mark.parametrize("device", DEVICES)
def test_parts_are_each_microbatch_and_the_update(mesh, device):
    w = sharded(mesh, (32, 16), device, requires_grad=True)
    with H.StepCounter() as c:
        for _ in range(2):
            x = sharded(mesh, (64, 32), device)
            (g,) = torch.autograd.grad((x @ w).sum(), [w])
        g = g.redistribute(mesh, [Shard(0)])  # w's layout
        g.to_local().mul_(0.5)
    parts = H.collective_bytes_per_computation(c)
    assert list(parts) == ["forward.0", "backward.0", "forward.1", "backward.1", "update"]
    for i in (0, 1):
        assert parts[f"forward.{i}"]["all-gather"] == 2048  # w gathered for the product
    update = c.parts()["update"]
    assert update["count"] == 1 and parts["update"]["total"] > 0
    assert update["bytes_accessed"] >= 2 * 8 * 16 * 4  # the in-place scale reads and writes the shard
    assert H.collective_bytes(c)["total"] == sum(p["total"] for p in parts.values())


@pytest.mark.parametrize("device", DEVICES)
def test_live_bytes(device):
    held = torch.zeros(10_000, device=device)
    with H.StepCounter() as c:
        c.hold({"state": [held]})
        held.add_(1)  # in place on an argument: nothing new
        a = torch.zeros(1000, device=device)
        b = torch.zeros(500, device=device)
        a.view(10, 100).t()  # views share a's storage
        del a
        d = torch.zeros(200, device=device)
    assert c.peak_bytes == (1000 + 500) * 4
    assert c.live_bytes == (500 + 200) * 4
    del b, d
    assert c.live_bytes == 0


@pytest.mark.parametrize("device", DEVICES)
def test_sharding_propagation_is_not_counted(mesh, device):
    """An op DTensor has not propagated before runs on fake tensors of the
    global shape first; only the local result counts."""
    x = sharded(mesh, (4096, 1000 + DEVICES.index(device)), device)
    with H.StepCounter() as c:
        y = torch.tanh(x)
    assert c.peak_bytes == y.to_local().numel() * 4 == 1024 * x.shape[1] * 4
    assert c.totals()["bytes_accessed"] == 2 * 1024 * x.shape[1] * 4


def test_flash_meta_calls_are_kernel_calls():
    q = torch.empty(2, 64, 4, 32, device="meta", dtype=torch.bfloat16)
    k = torch.empty(2, 64, 2, 32, device="meta", dtype=torch.bfloat16)
    with H.StepCounter() as c:
        flash_ops.flash_attention(q, k, k)
        flash_ops.flash_attention(q, k, k)
    assert c.flash_calls == 2
