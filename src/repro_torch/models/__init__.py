"""Model code of the port: ``layers``, ``attention``, ``slotstate``,
``transformer`` and the ``model`` API (``repro_torch.models.model``).
Submodules are imported by name; this package imports none of them, so
the kernel modules can use ``models.attention`` without a cycle."""
