from esrganplus_tpu_torch.ops.color import (bgr2ycbcr, channel_convert, modcrop, rgb2ycbcr,
                                            y_channel, ycbcr2rgb)
from esrganplus_tpu_torch.ops.image_io import (
    decode_img,
    encode_png,
    img2tensor,
    read_img,
    save_img,
    scan_images,
    tensor2img,
)
from esrganplus_tpu_torch.ops.metrics import calculate_psnr, calculate_ssim, psnr_torch, ssim_torch
from esrganplus_tpu_torch.ops.resize import imresize, imresize_np, resize_matrix

__all__ = ["bgr2ycbcr", "calculate_psnr", "calculate_ssim", "channel_convert", "decode_img",
           "encode_png", "img2tensor", "imresize", "imresize_np", "modcrop", "psnr_torch",
           "read_img", "resize_matrix", "rgb2ycbcr", "save_img", "scan_images", "ssim_torch",
           "tensor2img", "y_channel", "ycbcr2rgb"]
