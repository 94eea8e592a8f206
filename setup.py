from setuptools import find_packages, setup

setup(
    name="kspider-tpu",
    version="0.1.0",
    description="Accelerator sequence clustering engine (kSpider capabilities)",
    packages=find_packages(include=["kspider_tpu", "kspider_tpu.*"]),
    python_requires=">=3.9",
    install_requires=[
        "numpy",
        "jax",
        "scipy",
    ],
    entry_points={
        "console_scripts": [
            "kspider=kspider_tpu.cli.main:main",
        ]
    },
)
