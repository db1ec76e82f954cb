"""Model programs that plug into the verbs like any user code.

:mod:`.inception` (Inception-v3 image scoring through ``map_blocks``) is
imported here; :mod:`.logreg`, :mod:`.transformer` and :mod:`.generation`
import on first use.
"""

from . import inception  # noqa: F401

__all__ = ["inception"]
