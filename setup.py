from setuptools import find_packages, setup

setup(
    name='softgroup_tpu',
    version='0.1.0',
    description='TPU-native 3D point-cloud instance/semantic/panoptic '
                'segmentation (SoftGroup / SoftGroup++ capabilities)',
    packages=find_packages(include=('softgroup_tpu', 'softgroup_tpu.*',
                                    'softgroup_tpu_torch',
                                    'softgroup_tpu_torch.*')),
    python_requires='>=3.10',
    install_requires=['jax', 'flax', 'optax', 'orbax-checkpoint', 'numpy',
                      'scipy', 'pyyaml'],
    extras_require={
        'io': ['torch', 'plyfile'],
        'viz': ['open3d'],
    },
    package_data={'softgroup_tpu': ['csrc/*.cpp', 'csrc/*.py'],
                  'softgroup_tpu_torch': ['csrc/*.cu']},
)
