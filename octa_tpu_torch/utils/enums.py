"""Phase/Task enums that compare and hash like their string values.

Counterpart of ``octa_tpu/utils/enums.py:10-38``: ``config[Phase.TRAIN]``
must index the YAML section ``"Train"``, so a member is equal to, and hashes
like, its plain string.
"""
from enum import Enum


class StrValueEnum(Enum):
    """Enum whose members compare and hash equal to their string value."""

    def __eq__(self, other):
        if self.__class__ is other.__class__:
            return self.value == other.value
        if isinstance(other, str):
            return self.value == other
        return NotImplemented

    def __str__(self) -> str:
        return str(self.value)

    def __hash__(self) -> int:
        return hash(self.value)

    def __repr__(self) -> str:
        return repr(self.value)


class Phase(StrValueEnum):
    TRAIN = "Train"
    VALIDATION = "Validation"
    TEST = "Test"


class Task(StrValueEnum):
    VESSEL_SEGMENTATION = "ves-seg"
    GAN_VESSEL_SEGMENTATION = "gan-ves-seg"
