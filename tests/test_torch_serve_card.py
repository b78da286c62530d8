"""The port's ``StructureServeEngine`` on the card: batches go through the
hand-written kernel (one launch per padded level), and a kernel fault
fails the batch instead of falling back to the plain version.  Every
test here is ``gpu``-marked and skips inside its body where there is no
card; none needs JAX, which the GPU machine lacks."""

import numpy as np
import pytest
import torch

from repro_torch.core.structure import random_binary_tree
from repro_torch.dist.fault import ScriptedChaos, install_chaos
from repro_torch.kernels import level_megastep as lm
from repro_torch.models.treelstm import TreeLSTMVertex
from repro_torch.serve import StructureRequest, StructureServeEngine
from repro_torch.serve.robustness import FAILED, OK

INPUT_DIM, HIDDEN = 4, 72
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _requests(seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        leaves = int(rng.integers(2, 12))
        x = (rng.standard_normal((2 * leaves - 1, INPUT_DIM)) * 0.3
             ).astype(np.float32)
        out.append(StructureRequest(i, random_binary_tree(leaves, rng), x))
    return out


def _serve(fn, params, reqs, device, **kw):
    eng = StructureServeEngine(fn, params, batch_size=4, compose=False,
                               device=device, **kw)
    for r in reqs:
        assert eng.submit(r)
    eng.run()
    return eng


@pytest.mark.gpu
def test_card_engine_runs_the_kernel_once_per_padded_level():
    _need_card()
    fn = TreeLSTMVertex(input_dim=INPUT_DIM, hidden=HIDDEN)
    params = fn.init(torch.Generator().manual_seed(0), device="cuda")
    reqs = _requests(0, 10)
    lm.reset_launches()
    eng = _serve(fn, params, reqs, "cuda")
    levels = sum(shape[0] * n
                 for shape, n in eng.pipeline.census.counts().items())
    assert lm.LAUNCHES["treelstm_megastep"] == levels > 0
    h = eng.health()
    assert h["degradations"] == 0 and not h["breaker_open"]
    assert all(r.status == OK for r in reqs)
    cpu_reqs = _requests(0, 10)
    _serve(fn, {k: v.cpu() for k, v in params.items()}, cpu_reqs, "cpu")
    for r, c in zip(reqs, cpu_reqs):
        np.testing.assert_allclose(r.root_state, c.root_state, rtol=0,
                                   atol=TOL)


@pytest.mark.gpu
def test_card_kernel_fault_fails_the_batch_without_fallback():
    """Every fused attempt fails: on the card nothing degrades to the
    op-by-op path, the breaker stays closed, and the requests fail."""
    _need_card()
    fn = TreeLSTMVertex(input_dim=INPUT_DIM, hidden=HIDDEN)
    params = fn.init(torch.Generator().manual_seed(0), device="cuda")
    reqs = _requests(1, 4)
    hook = ScriptedChaos(fail={"kernel": list(range(100))})
    lm.reset_launches()
    with install_chaos(hook):
        eng = _serve(fn, params, reqs, "cuda", breaker_threshold=1)
    assert hook.calls["kernel"] > 0
    assert lm.LAUNCHES["treelstm_megastep"] == 0
    assert all(r.status == FAILED for r in reqs)
    assert all("injected kernel failure" in r.error for r in reqs)
    h = eng.health()
    assert h["degradations"] == 0 and not h["breaker_open"]
    assert eng.fused and eng.last_degradation is None
