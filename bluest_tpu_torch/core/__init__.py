from .groups import GroupStructure
from . import psi
