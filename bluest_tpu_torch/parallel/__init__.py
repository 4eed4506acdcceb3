from .hostcomm import HostComm, make_group_comms
from .mesh import (sample_mesh, sample_model_mesh, dcn_sample_model_mesh,
                   initialize_distributed, fetch_global,
                   SAMPLE_AXIS, MODEL_AXIS)
