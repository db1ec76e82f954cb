"""Model programs that plug into the verbs like any user code.

:mod:`.inception` (Inception-v3 image scoring through ``map_blocks``) and
:mod:`.vgg` (VGG-16 scoring with top-k) are imported here;
:mod:`.logreg`, :mod:`.transformer` and :mod:`.generation` import on
first use.
"""

from . import inception, vgg  # noqa: F401

__all__ = ["inception", "vgg"]
