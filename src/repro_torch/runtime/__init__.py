from repro_torch.runtime.elastic import ElasticPlanner, StragglerMonitor
