from setuptools import find_packages, setup

setup(
    name='wenet_tpu',
    version='0.1.0',
    description='TPU-native end-to-end speech recognition toolkit',
    packages=find_packages(include=['wenet_tpu*']),
    package_data={'wenet_tpu_torch': ['csrc/*.cu', 'csrc/*.cuh']},
    python_requires='>=3.10',
    install_requires=[
        'jax', 'flax', 'optax', 'orbax-checkpoint', 'numpy', 'pyyaml',
        'scipy',
    ],
    extras_require={
        'whisper': ['tiktoken'],
        'bpe': ['sentencepiece'],
        'hf': ['transformers'],
    },
    entry_points={
        'console_scripts': [
            'wenet-tpu = wenet_tpu.cli.transcribe:main',
        ],
    },
)
