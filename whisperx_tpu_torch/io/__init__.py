from .languages import LANGUAGES, LANGUAGES_WITHOUT_SPACES, TO_LANGUAGE_CODE
from .types import (
    AlignedTranscriptionResult,
    SingleAlignedSegment,
    SingleCharSegment,
    SingleSegment,
    SingleWordSegment,
    TranscriptionResult,
)
from .writers import get_writer

__all__ = [
    "LANGUAGES",
    "LANGUAGES_WITHOUT_SPACES",
    "TO_LANGUAGE_CODE",
    "AlignedTranscriptionResult",
    "SingleAlignedSegment",
    "SingleCharSegment",
    "SingleSegment",
    "SingleWordSegment",
    "TranscriptionResult",
    "get_writer",
]
