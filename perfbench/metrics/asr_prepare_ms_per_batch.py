"""Device milliseconds a decode batch spends before its loop: the
``asr.prepare`` spans (waveform upload, log-mel, encoder, cross K/V and
the prompt pass, up to the loop's launch) of the window's untraced files
over their ``asr.batch`` count."""

from benchlib import spans

NAME = "asr_prepare_ms_per_batch"
UNIT = "ms/batch"
LAYER = "pipeline and decode: upload, audio/mel.py, models/whisper.py encoder, cross K/V and prompt pass"
SOURCE = "program_span"
BETTER = "lower"
MOVES = "audio_s_per_s"


def read(record):
    reqs = spans.requests(record)
    if reqs is None:
        return None
    batches = len(spans.named(reqs["transcribe"], "asr.batch"))
    return spans.device_ms(spans.named(reqs["transcribe"], "asr.prepare")) / batches if batches else None
