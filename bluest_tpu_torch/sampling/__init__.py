from .engine import SampleSums, SamplingEngine, combine
