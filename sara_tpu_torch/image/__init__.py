"""Image processing (twin of ``sara_tpu/image``; its other modules are
imported by module, as in the twin)."""

from sara_tpu_torch.image.filtering import (gaussian_kernel_1d,
                                            separable_conv2d, gaussian_blur)
from sara_tpu_torch.image.transform import (resize_bilinear, downscale2,
                                            upscale2, bilinear_sample,
                                            warp_bilinear, warp_homography)
from sara_tpu_torch.image.differential import (gradient, gradient_polar,
                                              laplacian, hessian,
                                              second_moment_matrix,
                                              harris_cornerness)
from sara_tpu_torch.image.pyramid import (PyramidParams, GaussianPyramid,
                                          gaussian_pyramid, dog_pyramid)
from sara_tpu_torch.image.color import rgb_to_gray, gray_from_any

__all__ = [
    "gaussian_kernel_1d", "separable_conv2d", "gaussian_blur",
    "resize_bilinear", "downscale2", "upscale2", "bilinear_sample",
    "warp_bilinear", "warp_homography",
    "gradient", "gradient_polar", "laplacian", "hessian",
    "second_moment_matrix", "harris_cornerness",
    "PyramidParams", "GaussianPyramid", "gaussian_pyramid", "dog_pyramid",
    "rgb_to_gray", "gray_from_any",
]
