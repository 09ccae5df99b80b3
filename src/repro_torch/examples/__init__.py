"""The reference's ``examples/`` as modules of the port.

Each example is ``run(...)`` (the reference script's body, its sizes as
keyword arguments whose defaults are the script's constants, returning
what it prints) and ``main(argv=None)`` (the command line), so importing
one runs nothing.  They run on the CUDA card unless given ``--device cpu``
or ``device="cpu"``:

  PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
  PYTHONPATH=src python -m repro_torch.examples.multipod_hierarchy
  PYTHONPATH=src python -m repro_torch.examples.serve_per_node
  PYTHONPATH=src python -m repro_torch.examples.decentralized_llm_pretrain \\
      --full100m
"""
