"""ray_tpu_torch.tune: hyperparameter search over the actor runtime (port
of ray_tpu.tune).

Tuner.fit drives a TuneController event loop over trial actors (function
trainables, ``Trainable`` subclasses such as RLlib's algorithms, or a
``TorchTrainer``); searchers generate configs, schedulers make
early-stopping, HyperBand and PBT decisions. A trial computes on the
card only under a GPU lease: ``with_resources(fn, {"gpu": f})`` or
``TuneConfig(trial_resources={"num_gpus": f})``."""

from ray_tpu_torch.train.config import CheckpointConfig, FailureConfig, Result, RunConfig
from ray_tpu_torch.tune.schedulers import (
    ASHAScheduler,
    AsyncHyperBandScheduler,
    FIFOScheduler,
    HyperBandScheduler,
    MedianStoppingRule,
    PopulationBasedTraining,
    TrialScheduler,
    TuneBOHB,
)
from ray_tpu_torch.tune.search import (
    BasicVariantGenerator,
    HyperOptSearch,
    OptunaSearch,
    Searcher,
    choice,
    grid_search,
    lograndint,
    loguniform,
    quniform,
    randint,
    randn,
    sample_from,
    uniform,
)
from ray_tpu_torch.tune.trainable import (
    Trainable,
    get_checkpoint,
    get_trial_dir,
    get_trial_id,
    report,
    with_parameters,
    with_resources,
)
from ray_tpu_torch.tune.tuner import ResultGrid, Trial, TuneConfig, TuneController, Tuner, run

__all__ = [
    "ASHAScheduler",
    "HyperBandScheduler",
    "HyperOptSearch",
    "TuneBOHB",
    "CheckpointConfig",
    "AsyncHyperBandScheduler",
    "BasicVariantGenerator",
    "FIFOScheduler",
    "FailureConfig",
    "MedianStoppingRule",
    "OptunaSearch",
    "PopulationBasedTraining",
    "Result",
    "ResultGrid",
    "RunConfig",
    "Searcher",
    "Trainable",
    "Trial",
    "TrialScheduler",
    "TuneConfig",
    "TuneController",
    "Tuner",
    "choice",
    "get_checkpoint",
    "get_trial_dir",
    "get_trial_id",
    "grid_search",
    "lograndint",
    "loguniform",
    "quniform",
    "randint",
    "randn",
    "report",
    "run",
    "sample_from",
    "uniform",
    "with_parameters",
    "with_resources",
]
