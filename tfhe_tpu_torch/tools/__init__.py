"""The port's command-line tools: `security_estimate` (core-SVP bits of
each preset), `serving_bench` (the batch sweep over key forms) and
`batch_job` (a restartable checkpointed job). Each runs as
`python -m tfhe_tpu_torch.tools.<name>`."""
