"""Protocol models the variants read (the port's copy of
``pos_evolution_tpu/models/pvm.py``: the VRF leader preference and the
vote-subsampling predicate of Goldfish)."""
