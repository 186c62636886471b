"""Host IO: native shm ring bindings, async device feed, file formats.

Importing this package starts no JAX backend, so a ring master (rx_app)
stays off the card: the device feed lives in ``io.feed`` and is imported
only by the consumer.
"""

from .ring import RingError, RingShutdown, RingTimeout, SymbolRing
from .state import load_estimate, save_estimate

__all__ = [
    "RingError",
    "RingShutdown",
    "RingTimeout",
    "SymbolRing",
    "load_estimate",
    "save_estimate",
]
