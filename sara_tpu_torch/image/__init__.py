"""Image processing (twin of ``sara_tpu/image``, the slice's part)."""

from sara_tpu_torch.image.filtering import (gaussian_kernel_1d,
                                            separable_conv2d, gaussian_blur)
from sara_tpu_torch.image.transform import (resize_bilinear, downscale2,
                                            upscale2, bilinear_sample)
from sara_tpu_torch.image.differential import gradient
from sara_tpu_torch.image.pyramid import (PyramidParams, GaussianPyramid,
                                          gaussian_pyramid, dog_pyramid)

__all__ = [
    "gaussian_kernel_1d", "separable_conv2d", "gaussian_blur",
    "resize_bilinear", "downscale2", "upscale2", "bilinear_sample",
    "gradient",
    "PyramidParams", "GaussianPyramid", "gaussian_pyramid", "dog_pyramid",
]
