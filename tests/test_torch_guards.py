"""Static guards on the PyTorch port: it imports neither JAX nor the JAX
package, the CUDA sources keep every floating constant single precision,
and the kernel builds keep the flags their numerics rest on."""
import ast
import os
import re

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")
FORBIDDEN = ("jax", "jaxlib", "repro")
# the gpu-marked tests run where there is no JAX
JAX_FREE_TESTS = ("test_torch_gpu.py", "test_torch_gpu_flash.py", "test_torch_gpu_ssd.py",
                  "test_torch_gpu_rmsnorm.py", "test_torch_gpu_chain.py",
                  "test_torch_gpu_serve.py", "test_torch_gpu_train.py", "test_torch_gpu_moe.py",
                  "test_torch_gpu_analysis.py", "test_torch_gpu_mesh.py")


def port_sources(ext=".py"):
    out = []
    for d, _, files in os.walk(PORT):
        out += [os.path.join(d, f) for f in files if f.endswith(ext)]
    return sorted(out)


def absolute_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module


def test_port_imports_no_jax_and_no_reference_package():
    files = port_sources() + [os.path.join(ROOT, "chip_smoke.py")]
    files += [os.path.join(ROOT, "tests", f) for f in JAX_FREE_TESTS]
    files += [os.path.join(ROOT, "examples", f)
              for f in ("torch_quickstart.py", "torch_serve_batch.py", "torch_train_lm.py",
                        "torch_fault_tolerance.py")]
    assert len(files) > 40, files  # the scan sees the whole package
    for module in ("serve/scheduler.py", "serve/store.py", "core/campaign.py",
                   "core/event_sim.py", "runtime/health.py",
                   "models/model.py", "models/mamba2.py", "models/moe.py", "launch/serve.py",
                   "kernels/flash_attention/ops.py", "kernels/ssd/ops.py", "kernels/rmsnorm/ops.py",
                   "configs/registry.py", "kernels/_build.py", "models/flash_ref.py",
                   "optim/adamw.py", "optim/compress.py", "train/step.py", "data/pipeline.py",
                   "checkpoint/manager.py", "launch/train.py", "sharding/rules.py",
                   "sharding/specs.py", "roofline/analytic.py", "core/tpu_design.py",
                   "launch/autotune.py", "launch/mesh.py", "sharding/act.py",
                   "models/moe_shard_map.py", "runtime/elastic.py", "launch/dryrun.py",
                   "roofline/hlo.py"):
        assert os.path.join(PORT, module) in files, module
    bad = [
        (os.path.relpath(p, ROOT), line, mod)
        for p in files
        for line, mod in absolute_imports(p)
        if mod.split(".")[0] in FORBIDDEN
    ]
    assert not bad, bad


def test_cuda_sources_are_the_kernels():
    names = sorted(os.path.basename(p) for p in port_sources(".cu"))
    assert names == ["flash_attention.cu", "phase_sim.cu", "rmsnorm.cu", "ssd.cu"], names


@pytest.mark.parametrize("cu", port_sources(".cu"), ids=os.path.basename)
def test_cuda_source_has_only_float_constants(cu):
    """A double literal moves f32 arithmetic to double (the phase-sim retire
    test ``c_t <= phi * (1 + 1e-9)`` would then retire other tasks; the
    flash kernel's masked scores would leave f32; so would the SSD decay and
    the RMSNorm statistics)."""
    with open(cu) as f:
        src = f.read()
    code = re.sub(r"//[^\n]*|/\*.*?\*/", "", src, flags=re.S)
    floats = re.findall(r"(?<![\w.])(\d+\.\d*(?:e[+-]?\d+)?|\d+e[+-]?\d+)(f?)", code)
    assert floats, "no floating constants found: scan vacuous"
    doubles = [lit for lit, suffix in floats if not suffix]
    assert not doubles, doubles
    assert "double" not in code
    # the IEEE functions, never the fast approximations
    assert not re.search(r"__(expf|logf|fdividef|powf)\b", code)


@pytest.mark.parametrize("name", ["phase_sim", "flash_attention", "ssd", "rmsnorm"])
def test_kernel_build_flags(name):
    import importlib

    from repro_torch.kernels import _build

    kernel = importlib.import_module(f"repro_torch.kernels.{name}.kernel")
    flags = " ".join(kernel.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "use_fast_math" not in flags
    if name == "phase_sim":  # its comparisons flip on one contracted multiply-add
        assert "-fmad=false" in flags
    assert _build.BUILD_DIR.parts[-2:] == ("build", "kernels")
    assert _build.BUILD_DIR.parent.parent == type(_build.BUILD_DIR)(ROOT)
    assert kernel._LIB.source == kernel.SOURCE and kernel.SOURCE.exists()
    assert kernel._LIB.flags == tuple(kernel.NVCC_FLAGS)


def test_flash_source_is_built_on_hopper_primitives():
    """The flash kernel's tensor-core route is wgmma products fed by TMA
    copies under mbarriers, with the producer/consumer register split; a
    rewrite that drops any of them is a different kernel."""
    with open(os.path.join(PORT, "kernels", "flash_attention", "csrc", "flash_attention.cu")) as f:
        code = re.sub(r"//[^\n]*|/\*.*?\*/", "", f.read(), flags=re.S)
    for needle in ("wgmma.mma_async", "cp.async.bulk.tensor", "mbarrier.try_wait.parity",
                   "mbarrier.arrive.expect_tx", "setmaxnreg.dec", "setmaxnreg.inc", "wgmma.fence",
                   "cuTensorMapEncodeTiled", "CU_TENSOR_MAP_SWIZZLE_128B"):
        assert needle in code, needle
    assert "extern \"C\" int flash_attention_tc_launch" in code
    assert "extern \"C\" int flash_attention_launch" in code


@pytest.mark.parametrize("name,needles", [
    # the SSD tensor-core route: wgmma products fed by TMA under mbarriers,
    # h's hi/lo tiles made visible to the async proxy, both entry points
    ("ssd", ("wgmma.mma_async", "cp.async.bulk.tensor", "mbarrier.try_wait.parity",
             "mbarrier.arrive.expect_tx", "wgmma.fence", "fence.proxy.async", "cuTensorMapEncodeTiled",
             "CU_TENSOR_MAP_SWIZZLE_128B", "extern \"C\" int ssd_tc_launch", "extern \"C\" int ssd_launch")),
    # phase-sim: task sets as warp ballots and bitmasks, the parent mask packed
    ("phase_sim", ("__ballot_sync", "__match_any_sync", "__popc", "__ffs", "pwords",
                   "phase_sim_kernel<true>", "phase_sim_kernel<false>")),
])
def test_redesigned_source_is_built_on_its_primitives(name, needles):
    """A rewrite of the SSD or phase-sim kernel that drops any of these is a
    different design (the flash kernel's counterpart is above)."""
    with open(os.path.join(PORT, "kernels", name, "csrc", f"{name}.cu")) as f:
        code = re.sub(r"//[^\n]*|/\*.*?\*/", "", f.read(), flags=re.S)
    for needle in needles:
        assert needle in code, needle
