"""Launchers: the training CLI (``python -m repro_torch.launch.train``).

``launch/{mesh,sharding,dryrun}.py`` of the reference build multi-device
JAX meshes; one card has no mesh, so they have no counterpart.
"""
