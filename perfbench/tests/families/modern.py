"""A fixture family: the ``llama`` layout, with its published keys written
as newer configuration files write them: the experts counted under
``num_experts`` (no ``num_local_experts``) and RoPE's theta under
``rope_parameters`` (no top-level ``rope_theta``).  The ``llama`` family
refuses such a file; this one reads its own keys, under the names the
``llama`` check and reference read (``modern_reference.as_llama``).  It
counts the calls the harness makes into it (``CALLS``), so a test can see
that the driver and the control take their weights and reference from
here.

Found by name once its directory is on ``perfbench.families.__path__``
(``test_perfbench_families.py``)."""

import functools

from perfbench.families import llama
from perfbench.tests import modern_reference as reference
from perfbench.tests.modern_reference import CALLS


def counted(fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        CALLS[fn.__name__] += 1
        return fn(*args, **kwargs)
    return wrapper


@counted
def program_config(model):
    cfg = llama.preset(model)
    llama.check(cfg, {**model, "config": reference.as_llama(model["config"])})
    return cfg


@counted
def sizes(model):
    return llama.sizes({"config": reference.as_llama(model["config"])})


int8_top = counted(llama.int8_top)
int8_layer = counted(llama.int8_layer)
int8_tree = counted(llama.int8_tree)
