"""Online serving: stage cache, delta batches, async lane scheduler,
query service and open-loop stream driver. Import from the modules."""
