"""mccnn_tpu_torch stays free of JAX, of the JAX package (it keeps its own
copies of what it needs) and of library kernels, and its CPU path needs
neither ``nvcc`` nor ``triton``."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PKG = os.path.join(REPO, "mccnn_tpu_torch")
BANNED_TOP = {"jax", "jaxlib", "flax", "optax", "orbax"}


def port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def violations(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    found = []
    for node in ast.walk(tree):
        modules = []
        if isinstance(node, ast.Import):
            modules = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            modules = [node.module]
            if node.module == "mccnn_tpu":
                modules = [f"mccnn_tpu.{a.name}" for a in node.names]
        for m in modules:
            top = m.split(".")[0]
            if top in BANNED_TOP:
                found.append(f"imports {m}")
            elif top == "mccnn_tpu":
                found.append(f"imports {m} (the port keeps its own copy of what it needs)")
        if isinstance(node, ast.Attribute):
            if node.attr == "scaled_dot_product_attention":
                found.append("uses scaled_dot_product_attention")
            if node.attr == "compile" and isinstance(node.value, ast.Name) and node.value.id == "torch":
                found.append("uses torch.compile")
    return found


@pytest.mark.parametrize("path", port_sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_and_no_library_kernels(path):
    assert violations(path) == []


def test_scanner_flags_what_it_should(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(
        "import jax.numpy\nfrom flax import linen\nfrom mccnn_tpu import core\n"
        "from mccnn_tpu.utils import io\nimport torch\nf = torch.compile(g)\n"
        "torch.nn.functional.scaled_dot_product_attention(q, k, v)\n"
    )
    assert len(violations(str(bad))) == 6


_CPU_DRIVE = r"""
import sys
sys.modules["triton"] = None  # any `import triton` now fails
import torch
import importlib, pkgutil
import mccnn_tpu_torch
for m in pkgutil.walk_packages(mccnn_tpu_torch.__path__, "mccnn_tpu_torch."):
    importlib.import_module(m.name)
from mccnn_tpu_torch.api.hierarchy import build_hierarchy
from mccnn_tpu_torch.core.mcconv import init_mcconv_params
from mccnn_tpu_torch.core.pdf import kde_density
from mccnn_tpu_torch.core.sampling import poisson_disk
from mccnn_tpu_torch.models import MCClassS
from mccnn_tpu_torch.ops.cuda import _build, dense_mc_conv
from mccnn_tpu_torch.serve import make_predict_fn

g = torch.Generator().manual_seed(0)
pts = torch.rand((2, 64, 3), generator=g)
mask = torch.ones((2, 64), dtype=torch.bool)
mask[1, -5:] = False
pdf = kde_density(pts, mask, 0.3)
ss = poisson_disk(pts, mask, 0.2, 64)
feats = torch.randn((2, 64, 4), generator=g)
for c_out in (None, 3):
    p = init_mcconv_params(g, 4, c_out)
    out = dense_mc_conv(p, pts[:, :16], mask[:, :16], pts, mask, feats, pdf, 0.3, c_out=c_out)
    assert out.shape == (2, 16, 4 if c_out is None else 3)
h = build_hierarchy(pts, mask, (0.1, 0.4), global_level=True)
logits = make_predict_fn(MCClassS(5, grow=8))(pts, mask)
assert logits.shape == (2, 5) and bool(torch.isfinite(logits).all())
from mccnn_tpu_torch.tasks import modelnet
from mccnn_tpu_torch.train import batch_to_device, init_state, make_optimizer, make_train_step
model = modelnet.build_model("MCClassS", 5, 8)
opt = make_optimizer(model.parameters())
init_state(model, opt, seed=0)
step = make_train_step(model, opt, modelnet.make_loss("MCClassS"))
batch = {"points": pts.numpy(), "mask": mask.numpy(), "labels": [0, 3]}
loss, metrics = step(batch_to_device(batch, torch.device("cpu")))
assert bool(torch.isfinite(loss)) and opt.count == 1
from mccnn_tpu_torch.models import MCSeg
seg = MCSeg(4, grow=8, radii=(0.2,), tile_pairs=1 << 30, conv_backend="tile").eval()
with torch.inference_mode():
    seg_logits, overflow = seg(pts, mask, with_overflow=True)
assert seg_logits.shape == (2, 64, 4) and int(overflow) == 0
assert _build._LIBRARY is None, "the CPU path must not build the CUDA kernels"
banned = ("jax", "jaxlib", "flax", "optax", "orbax", "mccnn_tpu")
bad = [m for m in sys.modules if m.split(".")[0] in banned]
assert not bad, bad
print("ok")
"""


def test_cpu_path_needs_no_nvcc_no_triton_no_jax():
    # A fresh interpreter: this test process already imported JAX (conftest).
    env = {k: v for k, v in os.environ.items() if k not in ("CUDA_HOME", "CUDA_PATH")}
    env["PATH"] = os.pathsep.join(
        p for p in env.get("PATH", "").split(os.pathsep) if "cuda" not in p.lower()
    )
    env["PYTHONPATH"] = REPO
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run(
        [sys.executable, "-c", _CPU_DRIVE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")
