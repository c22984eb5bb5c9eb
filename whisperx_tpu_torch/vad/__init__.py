from .binarize import SpeechTurn, binarize, binarize_and_merge, merge_chunks, merge_vad
from .model import EnergyVAD, NeuralVAD, SpeechBandVAD, VadPipeline, VadScores, load_vad_model

__all__ = [
    "SpeechTurn",
    "binarize",
    "binarize_and_merge",
    "merge_chunks",
    "merge_vad",
    "EnergyVAD",
    "SpeechBandVAD",
    "NeuralVAD",
    "VadPipeline",
    "VadScores",
    "load_vad_model",
]
