"""Seeded random configurations of the attention fuzz (tests/test_fuzz.py's
draws, kept in order, then K1's modes), shared by the CPU fuzz against
JAX's oracle (tests/test_torch_fuzz.py), the card's kernels against their
plain versions (tests/test_torch_cuda.py) and ``chip_smoke.py``'s
``phase_fuzz``.  Configurations only: each caller draws its own tensors.
"""

import random

FORWARD_SEEDS = 12
BACKWARD_SEEDS = 6
DECODE_SEEDS = 6
#: K1's modes drawn after test_fuzz.py's forward draws: dense, segment ids
#: (both sides), a 128-granule block mask, int8 V with per-channel scales.
MODES = ("dense", "segments", "block_mask", "int8_v")
GRANULE = 128


def _segments(rng, n: int, docs: int) -> list:
    """Ascending document ids 0..docs-1 over n positions, each id present."""
    cuts = sorted(rng.sample(range(1, n), docs - 1)) if docs > 1 else []
    ids, start = [], 0
    for doc, end in enumerate(cuts + [n]):
        ids += [doc] * (end - start)
        start = end
    return ids


def forward_case(seed: int) -> dict:
    """test_fuzz.py:28-45's draws, then a mode and its masks.  Segment ids
    split q and kv into the same number of documents (equal ids when
    causal), and a block mask keeps each granule row's own (or last) column
    granule, so that no row loses every key to the mode alone."""
    rng = random.Random(seed)
    hkv = rng.choice([1, 2, 3])
    group = rng.choice([1, 2, 4, 5])
    sq = rng.randrange(16, 640)
    is_causal = rng.random() < 0.5
    skv = sq if is_causal else rng.randrange(16, 640)
    d = rng.choice([64, 128])
    dtype = rng.choice(["bfloat16", "float32"])
    window = None
    if rng.random() < 0.4:
        left = rng.randrange(8, max(9, sq))
        window = (left, 0 if is_causal else rng.randrange(0, 64))
    block_q = rng.choice([128, 256])
    block_kv = rng.choice([128, 256])
    case = dict(seed=seed, hkv=hkv, hq=hkv * group, sq=sq, skv=skv, d=d, dtype=dtype,
                is_causal=is_causal, window=window, block_q=block_q, block_kv=block_kv,
                mode=rng.choice(MODES))
    if case["mode"] == "segments":
        docs = rng.randint(1, min(4, sq, skv))
        case["kv_segment_ids"] = _segments(rng, skv, docs)
        case["q_segment_ids"] = list(case["kv_segment_ids"]) if is_causal else _segments(rng, sq, docs)
    elif case["mode"] == "block_mask":
        rows, cols = -(-sq // GRANULE), -(-skv // GRANULE)
        case["block_mask"] = [[rng.random() < 0.5 or j == min(i, cols - 1) for j in range(cols)]
                              for i in range(rows)]
    return case


def oracle_window(case: dict):
    """The oracle's window: a causal call's right extent is unbounded."""
    window = case["window"]
    return (window[0], None) if window and case["is_causal"] else window


def backward_case(seed: int) -> dict:
    """test_fuzz.py:65-72's draws."""
    rng = random.Random(1000 + seed)
    hkv = rng.choice([1, 2])
    group = rng.choice([1, 2, 4])
    sq = rng.randrange(64, 384)
    is_causal = rng.random() < 0.5
    d = rng.choice([64, 128])
    return dict(seed=seed, hkv=hkv, hq=hkv * group, sq=sq, is_causal=is_causal, d=d)


def decode_case(seed: int) -> dict:
    """test_fuzz.py:102-117's draws, then each slot's length."""
    rng = random.Random(1000 + seed)
    batch = rng.choice([2, 4])
    hkv = rng.choice([1, 2])
    group = rng.choice([1, 2, 4])
    smax = rng.choice([256, 384, 512])
    container = rng.choice(["int8", "int4", "bf16"])
    block_kv = rng.choice([128, 256])
    block_batch = rng.choice([1, 2])
    lens = [rng.randrange(0, smax + 1) for _ in range(batch)]
    return dict(seed=seed, batch=batch, hkv=hkv, hq=hkv * group, smax=smax, d=128, container=container,
                block_kv=block_kv, block_batch=block_batch, lens=lens)


# ---------------------------------------------------------------------------
# Inputs on a device (the card's checks; the CPU fuzz draws JAX's inputs)
# ---------------------------------------------------------------------------


def forward_inputs(case: dict, device, seed_offset: int = 0):
    """(q, k, v, kwargs) of a forward case: unit normals from a generator
    seeded by the case, in its dtype, and its mode's operands."""
    import torch

    from quantumattention_tpu_torch.ops import quant

    g = torch.Generator(device=device).manual_seed(case["seed"] + seed_offset)
    dtype = getattr(torch, case["dtype"])

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device, dtype=torch.float32).to(dtype)

    q = randn(1, case["hq"], case["sq"], case["d"])
    k = randn(1, case["hkv"], case["skv"], case["d"])
    v = randn(1, case["hkv"], case["skv"], case["d"])
    kw = {}
    if case["mode"] == "segments":
        kw = {n: torch.tensor([case[n]], dtype=torch.int32, device=device)
              for n in ("q_segment_ids", "kv_segment_ids")}
    elif case["mode"] == "block_mask":
        kw = {"block_mask": torch.tensor(case["block_mask"], dtype=torch.bool, device=device)}
    elif case["mode"] == "int8_v":
        v, kw["scale_v"] = quant.quantize_channel_wise(v.float())
    return q, k, v, kw


def decode_inputs(case: dict, device):
    """(q, k cache, v cache, lengths, kwargs) of a decode case: unit
    normals quantized to its container (int8, packed int4 with fp32
    token scales, or bf16)."""
    import torch

    from quantumattention_tpu_torch.ops import quant

    g = torch.Generator(device=device).manual_seed(2000 + case["seed"])
    b, hq, hkv, smax, d = case["batch"], case["hq"], case["hkv"], case["smax"], case["d"]
    q = torch.randn((b, hq, d), generator=g, device=device).to(torch.bfloat16)
    kraw = torch.randn((b, hkv, smax, d), generator=g, device=device)
    vraw = torch.randn((b, hkv, smax, d), generator=g, device=device)
    kw = {}
    if case["container"] in ("int8", "int4"):
        fn = quant.dynamically_quantize_int8 if case["container"] == "int8" else quant.dynamically_quantize_int4
        (kc, ks), (vc, vs) = fn(kraw), fn(vraw)
        kw = dict(k_scale=ks, v_scale=vs)
    else:
        kc, vc = kraw.to(torch.bfloat16), vraw.to(torch.bfloat16)
    lengths = torch.tensor(case["lens"], dtype=torch.int32, device=device)
    return q, kc, vc, lengths, kw


def to_cpu(tree):
    """A copy of tensors (in tuples, lists and dicts) on the CPU, where
    each kernel wrapper runs its plain version."""
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_cpu(v) for v in tree)
    return tree.cpu() if hasattr(tree, "cpu") else tree
