"""The plain float32 reference against the port at a tiny size on the CPU,
the port computing in float32 over the same int8 weights (plain products,
SDPA attention), with a sliding window shorter than the sequence and a
dropless Mixtral-style MoE."""

import dataclasses

import pytest
import torch

from perfbench import spec
from perfbench.families import llama as family
from perfbench.reference import llama as ref
from perfbench.tests import tiny


@pytest.mark.parametrize("moe", [False, True])
def test_reference_matches_port_in_float32(moe):
    from quantumattention_tpu_torch.models import llama

    model = tiny.model(moe)
    cfg = dataclasses.replace(spec.program_config(model), dtype=torch.float32, attention_impl="sdpa")
    seed = 2**31 + 5
    tree = family.int8_tree(cfg, seed, "cpu")
    g = torch.Generator().manual_seed(0)
    seqs = [torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist() for n in (80, 37)]
    want = [llama.forward(tree, torch.tensor([s]), cfg)[0] for s in seqs]
    sizes = family.sizes(model)
    got = ref.logits_at(ref.shape_of(model["config"]), seqs, [range(len(s)) for s in seqs],
                        family.int8_top(sizes, seed, "cpu"),
                        lambda i: family.int8_layer(sizes, i, seed, "cpu"))["ref"]
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) < 1e-4 * float(b.abs().max())


def test_window_matters():
    """The reference's window is live at this size: without it the logits
    past the window move."""
    model = tiny.model()
    sizes = family.sizes(model)
    seq = list(range(3, 83))
    args = dict(top=family.int8_top(sizes, 1, "cpu"), layer_fn=lambda i: family.int8_layer(sizes, i, 1, "cpu"))
    shape = ref.shape_of(model["config"])
    a = ref.logits_at(shape, [seq], [range(80)], **args)["ref"][0]
    b = ref.logits_at(dataclasses.replace(shape, window=None), [seq], [range(80)], **args)["ref"][0]
    assert torch.equal(a[:48], b[:48])
    assert float((a[60:] - b[60:]).abs().max()) > 1e-3


def test_int4_roundtrip():
    w = torch.randn(256, 64)
    r = ref.int4_roundtrip(w)
    groups = w.reshape(2, 128, 64).abs().amax(dim=1, keepdim=True) / 7
    assert float(((r - w).reshape(2, 128, 64).abs() - groups / 2).max()) <= 1e-6
    assert not torch.equal(r, w)


def test_gaps():
    r = torch.tensor([[0.0, 2.0, 1.0], [3.0, 1.0, 0.5]])
    assert ref.served_gaps(r, [1, 2]).tolist() == [0.0, 2.5]
    assert ref.chosen_gaps(r, torch.tensor([[0.0, 0.0, 9.0], [9.0, 0.0, 0.0]])).tolist() == [1.0, 0.0]
