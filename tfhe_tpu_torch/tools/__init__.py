"""The port's command-line tools: `security_estimate` (core-SVP bits of
each preset), `serving_bench` (the batch sweep over key forms),
`batch_job` (a restartable checkpointed job), `profile_bootstrap` (one
layer under torch.profiler, and the roofline), `pbs_bench` (LUT4/s on the
PBS preset) and `scaling_bench` (gates/s against the device count). Each
runs as `python -m tfhe_tpu_torch.tools.<name>`."""
