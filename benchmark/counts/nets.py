"""Multiply-add FLOPs (2 per multiply-add) of RefineNet and ScoreNet
forwards, from the layer shapes: a convolution is 2 x H_out x W_out x C_out
x k^2 x C_in, a dense layer 2 x rows x in x out, attention 2 x N^2 x d for
the scores and again for the weighted sum. Norms, activations, softmax and
the positional add are left out."""


def conv_out(n, k, stride):
    return (n + 2 * ((k - 1) // 2) - k) // stride + 1


def conv(h, w, cin, cout, k, stride):
    ho, wo = conv_out(h, k, stride), conv_out(w, k, stride)
    return 2 * ho * wo * cout * k * k * cin, ho, wo


def attention(n, d):
    """Self-attention over n tokens of width d: fused in-projection, scores,
    weighted sum, out-projection."""
    return 2 * n * d * 3 * d + 2 * 2 * n * n * d + 2 * n * d * d


def encoder(h, w, net):
    """Shared trunk per (rendered, observed) pair -> (flops, token grid)."""
    c0, c1, c2, c3 = net["encoder"]
    f0, h1, w1 = conv(h, w, net["c_in"], c0, 7, 2)
    f1, h2, w2 = conv(h1, w1, c0, c1, 3, 2)
    per_image = f0 + f1 + 4 * conv(h2, w2, c1, c1, 3, 1)[0]
    fab, h3, w3 = conv(h2, w2, c2, c3, 3, 2)
    pair = (2 * per_image + 4 * conv(h2, w2, c2, c2, 3, 1)[0] + fab
            + 4 * conv(h3, w3, c3, c3, 3, 1)[0])
    return pair, h3 * w3


def refinenet(pairs, h, w, net):
    """One forward over ``pairs`` crop pairs of h x w."""
    trunk, n = encoder(h, w, net)
    d, ff = net["d_model"], net["ff"]
    layer = attention(n, d) + 2 * 2 * n * d * ff
    heads = 2 * layer + 2 * n * d * 3 + 2 * n * d * net["rot_out"]
    return pairs * (trunk + heads)


def scorenet(pairs, h, w, net):
    """One forward over the ``pairs`` hypotheses of one frame."""
    trunk, n = encoder(h, w, net)
    d = net["d_model"]
    return pairs * (trunk + attention(n, d)) + attention(pairs, d) + 2 * pairs * d
