"""The benchmark's plain references: float32 PyTorch that imports nothing
of the program under test.

A configuration file names its reference module by its ``reference`` key;
``harness.load_cell`` loads ``reference/<name>.py`` once, when the cell is
loaded, and keeps it on the cell (``cell.reference``).  A new block enters
as a new module here, next to the configuration that names it; no other
file of the benchmark names a module.  Every module exports:

* ``forward(params, cfg, ids, *, cache_rows_from=None)`` — the logits
  (B, S, V) over the real vocabulary of ``ids`` (B, S), with the weights
  as ``weights.py`` lays them out and ``cfg`` the configuration file's
  dict; ``cache_rows_from=s`` computes rows from ``s`` on in the serving
  cache's arithmetic, where the configuration has one;
* ``seq_multiple(cfg)`` — the length a compared sequence is padded to
  (the serving check pads with token 0 at the end, which changes no
  earlier row).

A module that serves a training cell also exports ``token_loss(params,
cfg, tokens, labels)``, the summed next-token cross entropy, which
``train.py`` differentiates.  The control's switch to TF32 is one helper,
``decoder.tf32``, whatever the module: it sets torch's global flags.
"""
