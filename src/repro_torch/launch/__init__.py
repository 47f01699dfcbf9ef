"""Launchers: the training CLI (``python -m repro_torch.launch.train``),
the dry run on one card or a production mesh (``python -m
repro_torch.launch.dryrun``) and its roofline (``python -m
repro_torch.launch.roofline``); the meshes (:mod:`.mesh`) and the
sharding rules over them (:mod:`.sharding`).
"""
