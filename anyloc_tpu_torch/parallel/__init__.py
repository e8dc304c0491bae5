"""Multi-device layers of the port. Only the single-device router of
``ep.py`` is here; the rest comes with ROADMAP.md's port-queue item
"`parallel/` on `torch.distributed`"."""
