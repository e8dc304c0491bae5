"""The port's examples (counterparts of the repository root's
``examples/``): ``python -m anyloc_tpu_torch.examples.quickstart``,
``.serving`` and ``.multichip_retrieval`` (``--cpu`` runs each on the CPU),
and ``quickstart.ipynb``."""
