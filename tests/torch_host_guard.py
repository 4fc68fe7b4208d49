"""A guard that shows a step of the port reads nothing back to the host.

Inside ``no_host_reads()`` every way the port could read a tensor's value
into Python (``Tensor.__bool__``, ``__int__``, ``__float__``, ``item``,
``tolist``, ``cpu``, ``numpy``) raises when it is called from a module of
``ffvd_tpu_torch``.  On the card such a read is a synchronisation that a
CUDA graph cannot capture; on the CPU it costs nothing, so this guard is
how the CPU tests see it.  Reads made inside PyTorch itself are let
through: on the CPU ``torch.optim.Adam`` reads its step count with
``item()``, where on the card the capturable Adam keeps it on the device.
"""

import contextlib
import os
import sys

import torch

import ffvd_tpu_torch

_PORT = os.path.dirname(os.path.abspath(ffvd_tpu_torch.__file__))
_READS = ("__bool__", "__int__", "__float__", "item", "tolist", "cpu",
          "numpy")


@contextlib.contextmanager
def no_host_reads():
    original = {name: getattr(torch.Tensor, name) for name in _READS}

    def guarded(name):
        def read(self, *args, **kwargs):
            caller = sys._getframe(1).f_code.co_filename
            if os.path.abspath(caller).startswith(_PORT):
                raise AssertionError(
                    f"host read: Tensor.{name} from {caller}:"
                    f"{sys._getframe(1).f_lineno}")
            return original[name](self, *args, **kwargs)
        return read

    for name in _READS:
        setattr(torch.Tensor, name, guarded(name))
    try:
        yield
    finally:
        for name, fn in original.items():
            setattr(torch.Tensor, name, fn)
