from . import host_engine
from .engine import SampleSums, combine
from .group_engine import GroupEngine, SamplingEngine
from .host_engine import blue_fn
