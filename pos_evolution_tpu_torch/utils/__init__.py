"""Host utilities the spec layer uses (the port's copy of
``pos_evolution_tpu/utils/traversal.py``)."""
