"""The port's serving runtime: the DecodeServer engine core and the host
bookkeeping it runs on, and the SliceServer micro-batching executor."""

from nos_tpu_torch.runtime.decode_server import DecodeServer
from nos_tpu_torch.runtime.slice_server import SliceServer

__all__ = ["DecodeServer", "SliceServer"]
