"""The fixture family's reference (``families/modern.py``): the float32
reference of ``perfbench/reference/llama.py``, read from the fixture's
published keys.  ``CALLS`` counts the fixture's entry points as the
harness calls them."""

import collections

from perfbench.reference import llama as _llama
from perfbench.reference.llama import chosen_gaps, int4_roundtrip, served_gaps  # noqa: F401

CALLS = collections.Counter()


def as_llama(hf):
    """The fixture's keys under the names the llama reference reads."""
    out = {k: v for k, v in hf.items() if k not in ("num_experts", "rope_parameters")}
    out["rope_theta"] = hf["rope_parameters"]["rope_theta"]
    if hf.get("num_experts"):
        out["num_local_experts"] = hf["num_experts"]
    return out


def shape_of(hf):
    CALLS["shape_of"] += 1
    return _llama.shape_of(as_llama(hf))


def logits_at(*args, **kwargs):
    CALLS["logits_at"] += 1
    return _llama.logits_at(*args, **kwargs)
