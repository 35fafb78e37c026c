from pinot_tpu_torch.cluster.metadata import PropertyStore
from pinot_tpu_torch.cluster.controller import Controller
from pinot_tpu_torch.cluster.server import Server
from pinot_tpu_torch.cluster.broker import Broker

__all__ = ["PropertyStore", "Controller", "Server", "Broker"]
