"""The port's command-line tools, each run as ``python -m osmosis_tpu_torch.tools.<name>``:
the server (``serve``), the quality tools (``evaluate``, ``simulate_degraded``,
``validate_toy_e2e``, ``demo_toy_restore``, ``validate_checkpoint``), the
day-one runbook (``real_weights_runbook``, with ``runbook_rehearsal``) and the
grid's replication (``seed_replicate``), training and checkpoints
(``train_toy_prior``, ``check_prior_stats``, ``convert_checkpoint``) and the
card's benchmarks (``gn_bench``, ``unet_profile``, ``cudnn_determinism``)."""
