"""A tiny configuration and cells of the benchmark's shapes, for CPU tests:
K9's head dim of 128 and slots in sixteens, a window shorter than the
prompts; a Mixtral-style variant with 4 experts, top-2, dropless; a
backlog of four times the slots, traced over a stretch of its steps."""

import copy

from quantumattention_tpu_torch import config

FLAGS = {"kernel.qmm": "force", "kernel.qmlp": "force", "kernel.megastep": "force"}

MODEL = {
    "name": "tiny", "source": "tests", "preset": "tiny",
    "overrides": {"hidden_size": 256, "intermediate_size": 512, "num_q_heads": 4, "num_kv_heads": 2,
                  "head_dim": 128, "num_layers": 2, "vocab_size": 512, "window": 48},
    "config": {"hidden_size": 256, "intermediate_size": 512, "num_attention_heads": 4,
               "num_key_value_heads": 2, "num_hidden_layers": 2, "vocab_size": 512, "rope_theta": 10000.0,
               "rms_norm_eps": 1e-5, "sliding_window": 48, "head_dim": 128},
}

CELL = {
    "name": "tiny.waves", "config": "tiny", "chips": 1, "driver": "serve", "weights": "int8-fused",
    "engine": {"num_slots": 16, "max_len": 160, "prefill_bucket": 32, "decode_burst": 8},
    "traffic": {"kind": "waves", "requests_per_wave": 16, "prompt": 60, "new_tokens": 12},
    "check": {"sample_requests": 3, "compare": "gap_max", "limit": 0.5, "min_compared_tokens": 30},
}

BENCH = {
    "end_to_end": [{"name": n, "unit": u, "source": "host_clock"} for n, u in
                   (("output_tok_s", "tokens/s"), ("ttft_p95_ms", "ms"), ("tpot_p95_ms", "ms"), ("setup_s", "s"))],
    "per_layer": [
        {"name": "burst_step_pct", "unit": "%", "source": "program_counter", "moves": "output_tok_s",
         "workloads": ["tiny.waves", "tiny-moe.waves", "tiny-queue.waves"]},
        {"name": "decode_mfu", "unit": "%", "source": "host_clock", "moves": "output_tok_s",
         "workloads": ["tiny.waves", "tiny-moe.waves", "tiny-queue.waves"]},
        {"name": "k9_roofline", "unit": "%", "source": "device_trace", "moves": "output_tok_s",
         "workloads": ["tiny.waves", "tiny-queue.waves"]},
        {"name": "qmm_decode_roofline", "unit": "%", "source": "device_trace", "moves": "output_tok_s",
         "workloads": ["tiny-moe.waves"]},
        {"name": "idle_pct.decode", "unit": "%", "source": "device_trace", "moves": "output_tok_s",
         "workloads": ["tiny.waves", "tiny-moe.waves", "tiny-queue.waves"]},
    ],
}


def model(moe: bool = False):
    m = copy.deepcopy(MODEL)
    if moe:
        m["overrides"].update(num_experts=4, capacity_factor=2.0, window=None)
        m["config"].update(num_local_experts=4, num_experts_per_tok=2, sliding_window=None)
    return m


def cell(moe: bool = False, queue: bool = False):
    c = copy.deepcopy(CELL)
    c["model"] = model(moe)
    if queue:
        # 64 requests into 16 slots: four rounds of one prefill forward and
        # 11 decode steps, single steps while requests wait, bursts in the
        # last.  The traced stretch holds a round's last single steps, the
        # last round's forward and its first burst.
        c["name"] = "tiny-queue.waves"
        c["traffic"]["requests_per_wave"] = 4 * c["engine"]["num_slots"]
        c["traced_steps"] = [30, 36]
    if moe:
        # Rounding flips near-tied expert choices here as in Mixtral, so the
        # MoE cell compares the mean gap, as the Mixtral cell does.
        c.update(name="tiny-moe.waves", weights="int8")
        c["check"].update(compare="gap_mean", limit=0.1)
    return c


def kernels_forced():
    """The kernels' routes on CPU tensors (their plain versions), so the
    cells take the card's paths: K9 at decode, K5/K6 and K8 elsewhere."""
    return config.patch(FLAGS)
