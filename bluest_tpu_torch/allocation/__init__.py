from .sap import SAP
from .mosap import MOSAP, BLUESTError
