"""Device-loss signal (the single-device part of
``repro.runtime.elastic``).

``DeviceLoss`` is the injected-fault stand-in used by tests and the
failure drill in ``launch.train --inject-failure-at``: the loop treats
it as a lost device and recovers from the last checkpoint. On one
device there is no mesh to re-form, so the reference's
``largest_mesh``/``elastic_mesh`` have no counterpart here yet.
"""

from __future__ import annotations


class DeviceLoss(RuntimeError):
    """Raised when part of the device pool is gone."""

    def __init__(self, lost: int, msg: str = ""):
        self.lost = lost
        super().__init__(msg or f"lost {lost} devices")
