from .assign import Segment, assign_word_speakers
from .cluster import cluster_speakers
from .embed import MelStatsEmbedding, NeuralSpeakerEmbedding, ResNet34Embedding
from .pipeline import DiarizationPipeline
from .segmentation import NeuralSegmentation, OverlapDiarizer

__all__ = [
    "Segment",
    "assign_word_speakers",
    "cluster_speakers",
    "MelStatsEmbedding",
    "NeuralSpeakerEmbedding",
    "ResNet34Embedding",
    "DiarizationPipeline",
    "NeuralSegmentation",
    "OverlapDiarizer",
]
