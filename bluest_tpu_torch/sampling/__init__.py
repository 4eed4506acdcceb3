from . import host_engine
from .engine import SampleSums, SamplingEngine, combine
from .group_engine import GroupEngine
from .host_engine import blue_fn
