from .covariance import CovarianceGraph
from . import cliques
