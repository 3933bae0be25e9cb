"""The launch harness (counterpart of ``repro/launch/``): the production
meshes, the per-(arch x shape) specs of what a step takes, and the
dry-run that traces one rank's step on ``meta`` tensors at the
production mesh's shapes (``dryrun``), with the matrix runner
(``sweep``) and its tables (``summarize``).

Nothing here is imported by the training or serving paths; run the
dry-run as ``python -m repro_torch.launch.dryrun``.
"""
