"""Checkpoint-reconstructable model factories (the JAX package's
``utils/constructor.py``; reference ``model_constructor`` /
``NetConstructor``, HEM/utils_operations/model_constructor.py:5-66).

``@model_constructor`` records how a network was built (factory name,
module, arguments) on the returned ``nn.Module`` as ``.constructor``, as the
reference does; the record serialises to JSON beside a checkpoint and
rebuilds the same architecture:

    @model_constructor
    def build_net(crop_size=(320, 576)):
        return BasesHomoNet(BasesHomoConfig(crop_size=tuple(crop_size)))

    net = build_net(crop_size=(160, 288))
    net.constructor.save(ckpt_dir)                  # constructor.json
    net2 = NetConstructor.load(ckpt_dir).get()      # the same architecture
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
import json
import os


@dataclasses.dataclass
class NetConstructor:
    """A factory call: ``get`` re-imports the factory's module and calls it
    again.  The arguments must be JSON-serialisable."""

    fun_name: str
    fun_module: str
    args: tuple
    kwds: dict

    def get(self):
        return getattr(importlib.import_module(self.fun_module), self.fun_name)(
            *self.args, **self.kwds)

    def save(self, directory: str, name: str = "constructor.json") -> str:
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, name)
        with open(path, "w") as f:
            json.dump({"fun_name": self.fun_name, "fun_module": self.fun_module,
                       "args": list(self.args), "kwds": self.kwds}, f, indent=2)
        return path

    @classmethod
    def load(cls, directory: str, name: str = "constructor.json") -> "NetConstructor":
        with open(os.path.join(directory, name)) as f:
            d = json.load(f)
        return cls(d["fun_name"], d["fun_module"], tuple(d["args"]), d["kwds"])


def model_constructor(f):
    """Decorator: the factory's network (the first element of a tuple or
    list it returns) carries ``.constructor``, a :class:`NetConstructor`
    that rebuilds it."""

    @functools.wraps(f)
    def f_wrapper(*args, **kwds):
        output = f(*args, **kwds)
        net = output[0] if isinstance(output, (tuple, list)) else output
        net.constructor = NetConstructor(f.__name__, f.__module__, args, kwds)
        return output

    return f_wrapper
