from esrganplus_tpu_torch.ops.image_io import (
    decode_img,
    encode_png,
    img2tensor,
    read_img,
    save_img,
    scan_images,
    tensor2img,
)

__all__ = ["decode_img", "encode_png", "img2tensor", "read_img", "save_img",
           "scan_images", "tensor2img"]
