"""Entry points that drive the models: `serve.BatchedServer`, the batched
LM server; `train.train`, the LM training driver; `steps`, the train,
prefill and serve step functions."""
