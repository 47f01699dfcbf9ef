"""Launchers: the training CLI (``python -m repro_torch.launch.train``),
the one-card dry run (``python -m repro_torch.launch.dryrun``) and its
roofline (``python -m repro_torch.launch.roofline``).

``launch/{mesh,sharding}.py`` of the reference build multi-device JAX
meshes and the shardings over them; one card has no mesh, so they have no
counterpart.
"""
