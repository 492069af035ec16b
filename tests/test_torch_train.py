"""Port Llama training (loss_fn, gradients, train_step) against the JAX package.

``llama.tiny()`` (2 layers) params come from the JAX ``init_params`` and are
converted with ``models/convert.params_from_numpy``; the port's gradients
and updated parameters go back through ``params_to_numpy``.  Tokens are
(1, 65) from a numpy seed, so each model sees 64 positions.  On the CPU
the port's attention runs the kernels' plain versions (the backward of K2/
K3 included); the JAX side runs its Pallas kernels in interpret mode.

Tolerances: both frameworks run the layers in bf16 and round at other
places, so the loss may differ by 1e-2 relative and each gradient leaf by
5e-2 in relative Frobenius norm (measured: at most 2%).  The SGD step is
taken with lr = 100: the smallest mean gradient of a leaf is ~1e-3 and the
weights ~7e-2, so the update is far above one bf16 ulp of the weights and
the step's change of each leaf is held to the same 5e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantumattention_tpu.models import llama as jl
from quantumattention_tpu_torch.models import convert
from quantumattention_tpu_torch.models import llama as tl

LOSS_REL = 1e-2
GRAD_REL = 5e-2
LR = 100.0


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _f64(a):
    return np.asarray(a, np.float32).astype(np.float64)


def _rel_norm(a, b):
    a, b = _f64(a), _f64(b)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _paths(tree):
    """(name, leaf) pairs of a numpy tree in the port's leaf order."""
    names = [k for k in tree if k != "layers"]
    names += [f"layers.{i}.{k}" for i, layer in enumerate(tree["layers"]) for k in layer]
    return list(zip(names, tl.leaves(tree)))


@pytest.fixture(scope="module")
def jax_params():
    return jl.init_params(jax.random.PRNGKey(0), jl.tiny())


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(0).integers(0, 256, (1, 65)).astype(np.int32)


@pytest.fixture(scope="module", params=["bf16", "fp8"])
def runs(request, jax_params, tokens):
    """The same loss, gradients and SGD step in both packages."""
    impl = request.param
    jcfg, tcfg = jl.tiny(attention_impl=impl), tl.tiny(attention_impl=impl)
    jloss, jgrads = jax.value_and_grad(jl.loss_fn)(jax_params, jnp.asarray(tokens), jcfg)
    jnew, jstep_loss = jl.train_step(jax_params, jnp.asarray(tokens), jcfg, lr=LR)
    old = _np_tree(jax_params)
    tparams = convert.params_from_numpy(old, tcfg, device="cpu")
    ttokens = torch.from_numpy(tokens).long()
    tloss, tgrads = tl.loss_and_grads(tparams, ttokens, tcfg)
    tnew, tstep_loss = tl.train_step(tparams, ttokens, tcfg, lr=LR)
    return {
        "impl": impl,
        "loss": (float(tloss), float(jloss)),
        "step_loss": (float(tstep_loss), float(jstep_loss)),
        "grads": (convert.params_to_numpy(tgrads), _np_tree(jgrads)),
        "new": (convert.params_to_numpy(tnew), _np_tree(jnew)),
        "old": old,
        "tparams": tparams,
    }


def test_loss_matches_jax(runs):
    for t, j in (runs["loss"], runs["step_loss"]):
        assert np.isfinite(t)
        assert abs(t - j) <= LOSS_REL * abs(j), (runs["impl"], t, j)


def test_grads_match_jax(runs):
    tgrads, jgrads = runs["grads"]
    jflat = dict(_paths(jgrads))
    for name, g in _paths(tgrads):
        assert g.shape == jflat[name].shape and g.dtype == jflat[name].dtype, name
        assert np.isfinite(_f64(g)).all(), name
        assert _rel_norm(g, jflat[name]) < GRAD_REL, (runs["impl"], name)


def test_train_step_params_match_jax(runs):
    tnew, jnew = runs["new"]
    jflat, oflat = dict(_paths(jnew)), dict(_paths(runs["old"]))
    for name, p in _paths(tnew):
        assert p.dtype == jflat[name].dtype, name
        step_t = _f64(p) - _f64(oflat[name])
        step_j = _f64(jflat[name]) - _f64(oflat[name])
        assert np.linalg.norm(step_j) > 0, name
        assert _rel_norm(step_t, step_j) < GRAD_REL, (runs["impl"], name)
    # In place: the returned tree is the caller's, with no autograd state left.
    assert all(not p.requires_grad for p in tl.leaves(runs["tparams"]))


def test_params_to_numpy_round_trips_bit_exact(jax_params):
    old = _np_tree(jax_params)
    back = convert.params_to_numpy(convert.params_from_numpy(old, tl.tiny(), device="cpu"))
    for (name, a), (_, b) in zip(_paths(back), _paths(old)):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("impl", ["fp8", "bf16", "sdpa"])
def test_forward_is_differentiable(impl):
    """``forward`` records autograd history (it was forward-only before);
    the serving forwards stay outside autograd."""
    cfg = tl.tiny(attention_impl=impl)
    params = tl.init_params(torch.Generator().manual_seed(0), cfg)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (1, 16)))
    params["layers"][0]["wq"].requires_grad_(True)
    logits = tl.forward(params, tokens, cfg)
    assert logits.requires_grad and logits.dtype == torch.float32
    (g,) = torch.autograd.grad(logits.sum(), params["layers"][0]["wq"])
    assert bool(torch.isfinite(g.float()).all()) and float(g.float().abs().max()) > 0
    prefill, _ = tl.forward_prefill(params, tokens, cfg)
    assert not prefill.requires_grad
