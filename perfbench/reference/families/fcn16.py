"""FCN_16_standard_no_STN (Chen et al., MaxStyle, MICCAI 2022), feature
reduce 4: a five-stage residual encoder (16-32-64-128-128 channels), a
code decoupler, the FCN decoder with nearest-neighbour upsampling for the
segmentation and with 2x2 transposed convolutions and a sigmoid head for
the image (``nets.fcn_decode``, 64-32-16-16)."""

import torch

from perfbench.reference.nets import batch_norm, conv, fcn_decode, lrelu

ENC_CH = (16, 32, 64, 128, 128)
LATENT = 128


def res_down(P, name, x, cout):
    x = conv(P, f"{name}.down", x, x.shape[1], 3, stride=2)
    h = lrelu(batch_norm(P, f"{name}.norm1", conv(P, f"{name}.conv1", x, cout, 3)))
    h = batch_norm(P, f"{name}.norm2", conv(P, f"{name}.conv2", h, cout, 3))
    return lrelu(conv(P, f"{name}.conv_input", x, cout, 1) + h)


def general_encoder(P, x):
    p = "image_encoder.general_encoder"
    h = lrelu(batch_norm(P, f"{p}.inc.norm1", conv(P, f"{p}.inc.conv1", x, ENC_CH[0], 3)))
    h = lrelu(batch_norm(P, f"{p}.inc.norm2", conv(P, f"{p}.inc.conv2", h, ENC_CH[0], 3)))
    for i in range(1, 5):
        h = res_down(P, f"{p}.down{i}", h, ENC_CH[i])
    return torch.relu(batch_norm(P, f"{p}.final_norm", conv(P, f"{p}.final_conv", h, LATENT, 1)))


def code_decoupler(P, z):
    p = "image_encoder.code_decoupler"
    h = lrelu(batch_norm(P, f"{p}.norm1", conv(P, f"{p}.conv1", z, LATENT, 3, bias=False)))
    return torch.relu(batch_norm(P, f"{p}.norm2", conv(P, f"{p}.conv2", h, LATENT, 3,
                                                       bias=False)))


def encode(P, x):
    z = general_encoder(P, x)
    return z, code_decoupler(P, z)


def segment(P, z_s, num_classes):
    return fcn_decode(P, "segmentation_decoder", z_s, num_classes, False, False)


def decode_image(P, z_i, **kw):
    return fcn_decode(P, "image_decoder", z_i, 1, True, True, **kw)
