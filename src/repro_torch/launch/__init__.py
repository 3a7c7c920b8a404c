"""Entry points that drive the models: `serve.BatchedServer`, the batched
LM server."""
