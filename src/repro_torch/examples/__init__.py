"""The training examples of the port (counterparts of ``examples/``),
run as ``python -m repro_torch.examples.<name>``: ``quickstart`` (train,
checkpoint and serve a 2-layer qwen2.5-3b) and ``train_100m`` (a ~100M
llama-family model with checkpoint / restart)."""
