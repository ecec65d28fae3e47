"""The examples of the port (counterparts of ``examples/``), run as
``python -m repro_torch.examples.<name>``: ``quickstart`` (train,
checkpoint and serve a 2-layer qwen2.5-3b), ``train_100m`` (a ~100M
llama-family model with checkpoint / restart), ``serve_demo`` (serving
across weight precisions beside the energy model), ``long_context``
(cache footprints of long decodes) and ``characterize`` (the probe
suite)."""
