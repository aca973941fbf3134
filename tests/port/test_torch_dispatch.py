"""``MCCNN_TPU_CONV_BACKEND`` in the port's dispatch against the reference's.

The reference reads the variable at every dispatch (``mccnn_tpu/ops/dispatch.py``);
the port reads it once, when ``mccnn_tpu_torch.ops.dispatch`` is imported,
into ``_FORCED``. Each case sets the variable for the reference and the
port's constant for the port, and holds the port's ``pick_backend`` to the
reference's over a grid of site shapes wherever the reference's value is
forced. Nothing here compiles JAX: only the reference's dispatch module runs.
"""

import importlib.util

import numpy as np
import pytest
import torch

from mccnn_tpu.ops import dispatch as jdispatch
from mccnn_tpu_torch.api.hierarchy import GLOBAL_RADIUS
from mccnn_tpu_torch.models import MCClassS
from mccnn_tpu_torch.ops import dispatch
from mccnn_tpu_torch.ops.cuda import dense_conv, mcconv_kernel
from mccnn_tpu_torch.serve import make_predict_fn

VAR = "MCCNN_TPU_CONV_BACKEND"
VALUES = (None, "pallas", "bucket", "dense", "jnp", "tile", "Dense ")  # the last one misspelt
# (n_sources, radius, c_in, c_out, n_samples): MCClassS's three sites, a
# ShapeNet 1024 -> 1024 site, a big scene's level 0, a site past the dense
# envelope with a radius too large for buckets, and a depthwise site.
SITES = [(1024, 0.2, 1, 128, 496), (496, 0.8, 128, 256, 40), (40, GLOBAL_RADIUS, 256, 1024, 1),
         (1024, 0.025, 17, 64, 1024), (8192, 0.05, 1, 64, 8192), (4096, 0.5, 128, 128, 4096),
         (1944, 0.3, 128, None, 224)]


def _set(monkeypatch, value):
    if value is None:
        monkeypatch.delenv(VAR, raising=False)
    else:
        monkeypatch.setenv(VAR, value)
    monkeypatch.setattr(dispatch, "_FORCED", dispatch._forced_backend(value))


@pytest.mark.parametrize("value", VALUES, ids=lambda v: repr(v))
def test_forced_backend_routes_as_the_reference(monkeypatch, value):
    _set(monkeypatch, value)
    forced = jdispatch.conv_backend()
    assert dispatch._FORCED == forced
    for site in SITES:
        want = jdispatch.pick_backend(*site)
        got = dispatch.pick_backend(*site)
        if forced != "auto":
            assert got == want == forced, site
        else:  # both route by shape; the reference's CPU route is its jnp conv
            n, r, c, co, m = site
            fits = dispatch.dense_fits(n, c, co, m)
            assert fits == jdispatch.dense_fits(n, c, co, m)
            assert got == ("dense" if fits else "bucket" if np.ceil(1 / r) >= 4 else "jnp")
        # an explicit mode forces its own backend whatever the variable says
        assert dispatch.pick_backend(*site, mode="tile") == "tile"


@pytest.mark.parametrize("value", VALUES, ids=lambda v: repr(v))
def test_constant_is_read_at_import(monkeypatch, value):
    """A fresh import of the port's module under the variable reads what the
    reference reads."""
    _set(monkeypatch, value)
    spec = importlib.util.spec_from_file_location("_dispatch_fresh", dispatch.__file__)
    fresh = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fresh)
    assert fresh._FORCED == jdispatch.conv_backend()


def test_forced_bucket_routes_mcclass_s(monkeypatch):
    """Under a forced ``bucket`` every MCClassS site, conv_0_1 first, takes the
    bucket conv (its plain version here); by default they take the dense one."""
    calls = {"bucket": [], "dense": []}
    bucket_plain, dense_plain = mcconv_kernel.bucket_conv_reference, dense_conv._forward_reference

    def bucket_spy(params, sample_grid, source_grid, wf, **kw):
        calls["bucket"].append(tuple(wf.shape))
        return bucket_plain(params, sample_grid, source_grid, wf, **kw)

    def dense_spy(params, smp, qmask, src, smask, wf, *args, **kw):
        calls["dense"].append(tuple(wf.shape))
        return dense_plain(params, smp, qmask, src, smask, wf, *args, **kw)

    monkeypatch.setattr(mcconv_kernel, "bucket_conv_reference", bucket_spy)
    monkeypatch.setattr(dense_conv, "_forward_reference", dense_spy)
    rng = np.random.default_rng(0)
    pts = torch.from_numpy(rng.random((2, 256, 3), dtype=np.float32))
    mask = torch.ones((2, 256), dtype=torch.bool)
    model = MCClassS(5, grow=8, generator=torch.Generator().manual_seed(0)).eval()
    routed = {}
    for value in ("bucket", None):
        _set(monkeypatch, value)
        calls["bucket"].clear()
        calls["dense"].clear()
        logits = make_predict_fn(model)(pts, mask)
        assert torch.isfinite(logits).all()
        routed[value] = {k: list(v) for k, v in calls.items()}
    # conv_0_1 sees the 256 level-0 points with one feature channel
    assert routed["bucket"]["dense"] == [] and len(routed["bucket"]["bucket"]) == 3
    assert routed["bucket"]["bucket"][0] == (2, 256, 1)
    assert routed[None]["bucket"] == [] and len(routed[None]["dense"]) == 3
