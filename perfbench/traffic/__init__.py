"""Traffic generators, one module a kind, found by the cell's
``traffic["kind"]``; each exposes ``make(params, vocab_size, seed)``."""

import importlib


def load(params, vocab_size: int, seed: int):
    return importlib.import_module(f"perfbench.traffic.{params['kind']}").make(params, vocab_size, seed)
