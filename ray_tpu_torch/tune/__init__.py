"""ray_tpu_torch.tune — hyperparameter search over the cluster runtime.

Counterpart of ``ray_tpu/tune`` (ref: Ray Tune): the same variants,
TPE suggestions and ASHA/PBT decisions for the same seeds and results.
"""

from .schedulers import (ASHAScheduler, FIFOScheduler,  # noqa
                         PopulationBasedTraining)
from .search import (Searcher, TPESearcher, choice,  # noqa
                     grid_search, loguniform, randint, sample_from,
                     uniform)
from .tuner import (ResultGrid, TuneConfig, Tuner,  # noqa: F401
                    get_checkpoint, report)
