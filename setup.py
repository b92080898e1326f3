from setuptools import Extension, setup

setup(
    name="usher-jax",
    ext_modules=[
        Extension(
            "usher_jax.native._usher_native",
            sources=["usher_jax/native/src/usher_native.cpp"],
            libraries=["z"],
            extra_compile_args=["-O3", "-std=c++17"],
        )
    ],
)
