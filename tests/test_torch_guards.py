"""Static guards on the PyTorch port: it imports neither JAX nor the JAX
package, the CUDA source keeps every floating constant single precision,
and the kernel build keeps the flags its numerics rest on."""
import ast
import os
import re

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")
CU = os.path.join(PORT, "kernels", "phase_sim", "csrc", "phase_sim.cu")
FORBIDDEN = ("jax", "jaxlib", "repro")


def port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PORT):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
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
    files = port_sources()
    assert len(files) > 20, files  # the scan sees the whole package
    bad = [
        (os.path.relpath(p, ROOT), line, mod)
        for p in files
        for line, mod in absolute_imports(p)
        if mod.split(".")[0] in FORBIDDEN
    ]
    assert not bad, bad


def test_cuda_source_has_only_float_constants():
    """A double literal moves an f32 comparison to double (the retire test
    ``c_t <= phi * (1 + 1e-9)`` would then retire other tasks)."""
    with open(CU) as f:
        src = f.read()
    code = re.sub(r"//[^\n]*|/\*.*?\*/", "", src, flags=re.S)
    floats = re.findall(r"(?<![\w.])(\d+\.\d*(?:e[+-]?\d+)?|\d+e[+-]?\d+)(f?)", code)
    assert floats, "no floating constants found: scan vacuous"
    doubles = [lit for lit, suffix in floats if not suffix]
    assert not doubles, doubles
    assert "double" not in code


def test_kernel_build_flags():
    from repro_torch.kernels.phase_sim import kernel

    flags = " ".join(kernel.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-fmad=false" in flags and "fast_math" not in flags
    assert kernel.BUILD_DIR.parts[-2:] == ("build", "kernels")
    assert kernel.SOURCE.exists()
