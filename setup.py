from setuptools import find_packages, setup

setup(
    name="whisperx_tpu",
    version="0.1.0",
    description="TPU-native speech transcription with word-level timestamps "
    "(VAD cut&merge, batched Whisper beam decode, wav2vec2 CTC forced "
    "alignment, speaker diarization) on JAX/XLA/Pallas",
    python_requires=">=3.10",
    # whisperx_tpu (JAX) and whisperx_tpu_torch (its PyTorch/CUDA port,
    # which needs torch and, for its kernels, nvcc; not listed below).
    packages=find_packages(exclude=["tests*", "benchmarks*"]),
    package_data={"whisperx_tpu_torch": ["csrc/*.cu"]},
    install_requires=[
        "jax",
        "flax",
        "optax",
        "numpy",
        "scipy",
        "pandas",
        "tokenizers",
        "safetensors",
        "nltk",
    ],
    extras_require={"dev": ["pytest"]},
    entry_points={
        "console_scripts": [
            "whisperx-tpu=whisperx_tpu.cli:cli",
            "whisperx-tpu-torch=whisperx_tpu_torch.cli:cli",
        ]
    },
)
