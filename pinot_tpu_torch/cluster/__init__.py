from pinot_tpu_torch.cluster.metadata import PropertyStore
from pinot_tpu_torch.cluster.controller import Controller

__all__ = ["PropertyStore", "Controller", "Server", "Broker"]


def __getattr__(name):
    # the server and the broker load torch when imported; a controller
    # process, which has no device work, imports neither
    if name == "Server":
        from pinot_tpu_torch.cluster.server import Server

        return Server
    if name == "Broker":
        from pinot_tpu_torch.cluster.broker import Broker

        return Broker
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
