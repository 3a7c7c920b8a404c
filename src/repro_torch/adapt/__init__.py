from repro_torch.adapt.knobs import LayoutPlan
from repro_torch.adapt.search import LayoutReoptimizer
