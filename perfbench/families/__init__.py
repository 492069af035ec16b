"""Configuration families: what is specific to one model layout, found by
the configuration file's ``"family"`` key (``llama`` where the file has
none) as the module ``perfbench.families.<family>``.

A family module holds

- ``program_config(model)``: the program's config for a configuration
  file (its ``preset`` and ``overrides``), checked against the file's
  published keys however the family names them; a preset that disagrees
  with the file raises, so the file is the configuration as run;
- ``sizes(model)``: the sizes its weights are drawn by, from the published
  keys alone (the reference's side takes nothing of the program's config);
- ``int8_top(sizes, seed, device)``, ``int8_layer(sizes, idx, seed,
  device)`` and ``int8_tree(sizes, seed, device)``: the served int8 tree,
  each leaf drawn by its own name with ``perfbench/weights``' primitives,
  so the reference can draw any leaf again alone;
- ``reference``: the module of its float32 reference (``shape_of``,
  ``logits_at``, ``served_gaps``, ``chosen_gaps`` and the control's
  ``int4_roundtrip``), which imports nothing of the program.

Its metric readers take their operation and byte counts from a file of
the family's own (the ``llama`` family's are ``perfbench/work.py``).  A
new architecture's cell is new files: a family module, its reference,
its counts and readers, a configuration file naming the family.
"""

DEFAULT = "llama"
