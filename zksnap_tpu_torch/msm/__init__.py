from .pippenger import MSM, bn254_msm, msm_impl, window_digits
