"""The port's ``distributed`` surface: so far only ``fleet.utils.recompute``
(meshes and collectives wait for ROADMAP queue 1 item 5c)."""
