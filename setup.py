from setuptools import find_packages, setup

setup(
    name="dlrover-tpu",
    version="0.1.0",
    description=(
        "TPU-native elastic, fault-tolerant training framework "
        "(JAX/XLA/pjit/Pallas)"
    ),
    packages=find_packages(include=[
        "dlrover_tpu", "dlrover_tpu.*",
        "dlrover_tpu_torch", "dlrover_tpu_torch.*",
    ]),
    # the port's CUDA sources are compiled with nvcc at first use
    package_data={"dlrover_tpu_torch.ops": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "optax",
        "grpcio",
        "numpy",
        "psutil",
    ],
    entry_points={
        "console_scripts": [
            "dlrover-tpu-run = dlrover_tpu.run.elastic_run:main",
            "dlrover-tpu-master = dlrover_tpu.master.main:main",
        ],
    },
)
