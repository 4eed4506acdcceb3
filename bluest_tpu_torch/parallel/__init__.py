from .hostcomm import HostComm, make_group_comms
