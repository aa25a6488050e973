"""The port's serving runtime: the DecodeServer engine core and the host
bookkeeping it runs on."""

from nos_tpu_torch.runtime.decode_server import DecodeServer

__all__ = ["DecodeServer"]
