from setuptools import find_packages, setup

setup(
    name="heybuddy-tpu",
    version="0.1.0",
    description="TPU-native wake-word training and deployment framework (JAX/XLA/Pallas)",
    packages=find_packages(
        include=["heybuddy_tpu", "heybuddy_tpu.*", "heybuddy_tpu_torch", "heybuddy_tpu_torch.*"]
    ),
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "numpy",
        "scipy",
        "click",
        "optax",
    ],
    extras_require={
        "data": ["datasets", "tokenizers"],
        "viz": ["matplotlib"],
    },
    entry_points={
        "console_scripts": [
            "heybuddy = heybuddy_tpu.cli:main",
        ],
    },
)
