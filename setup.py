from setuptools import find_packages, setup

setup(
    name="syconn_tpu",
    version="0.1.0",
    description="TPU-native connectomics framework (synaptic connectivity inference)",
    packages=find_packages(include=["syconn_tpu", "syconn_tpu.*",
                                    "syconn_tpu_torch", "syconn_tpu_torch.*"]),
    package_data={
        "syconn_tpu.handler": ["default_config.yml"],
        "syconn_tpu.csrc": ["*.cpp"],
        "syconn_tpu.analysis": ["viewer.html"],
        "syconn_tpu_torch.ops": ["csrc/*.cu", "csrc/*.cpp"],
        "syconn_tpu_torch.handler": ["default_config.yml"],
        "syconn_tpu.models": ["pretrained/*/arch.json",
                              "pretrained/*/params.msgpack",
                              "pretrained/*/meta.json"],
    },
    python_requires=">=3.10",
    install_requires=[
        "numpy",
        "scipy",
        "networkx",
        "h5py",
        "pyyaml",
        "zstandard",
        "tqdm",
        "jax",
        "flax",
        "optax",
    ],
    entry_points={
        "console_scripts": [
            "syconn.server=syconn_tpu.analysis.server:main",
            "syconn.example=syconn_tpu.examples.start:main",
        ]
    },
)
