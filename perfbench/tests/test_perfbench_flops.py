"""The operation counts match counts made by hand."""

from benchlib import flops, spec

V2 = spec.load_cell("large-v2-int8.longform-dense").config


def test_large_v2_encoder_by_hand():
    conv = 2 * 3 * 80 * 1280 * 3000 + 2 * 3 * 1280 * 1280 * 1500
    layer = 2 * 1500 * 1280 * 3840 + 2 * (2 * 1500 * 1500 * 1280) + 2 * 1500 * 1280**2 + 2 * (2 * 1500 * 1280 * 5120)
    assert flops.whisper_encoder(V2["whisper"]) == conv + 32 * layer == 2_272_665_600_000


def test_large_v2_decoder_row_by_hand():
    # position 10: self-attention over 11 keys, cross-attention over 1500 frames
    per_layer = 2 * 1280 * 3840 + 4 * 1280 * 11 + 2 * 1280**2 + 2 * 1280**2 + 4 * 1280 * 1500 + 2 * 1280**2 + 4 * 1280 * 5120
    assert flops.whisper_decoder_row(V2["whisper"], 10) == 32 * per_layer + 2 * 1280 * 51865


def test_wav2vec2_frames_of_a_second():
    assert flops.wav2vec2_frames(V2["wav2vec2"], 16000)[-1] == 49
