"""Useful operations and bytes of the published CascadedNet, from shapes.

Every count is a function of the configuration (n_fft, nout, nout_lstm)
and the patch batch (N, crop); nothing is read from the program. Counted
(2 operations a multiply-add):
  * every convolution, as a dense product over its kernel window, zero
    padding included (what `torch.utils.flop_counter` counts);
  * the BiLSTM's products: the input projection and the recurrent
    product of both directions, T = crop / 2 steps;
  * the dense head of each LSTM branch;
  * the bilinear resizes as a separable lerp: 3 operations (subtract,
    multiply, add) an output element of each axis pass. This is not the
    interpolation-matrix product some implementations run: a change of
    how the resize is computed does not change the useful work.
Not counted: batch norm, activations, the LSTM's gates, the mask head's
sigmoid, the STFT and iSTFT (all far below 1% of the total).

A training step adds, for each product, the gradient of its input (when
that input needs one: not for a data slice fed to a first layer) and of
its weight, and one more lerp a resize output.
"""

from __future__ import annotations

from dataclasses import dataclass

# published peaks of one NVIDIA H100 SXM at 700 W (NVIDIA data sheet;
# dense, no sparsity), the rates the roofline shares are taken against
PEAK_F32_FLOPS = 67e12     # float32 without tensor cores (TF32 off)
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12       # HBM3

PEAKS = {"highest": PEAK_F32_FLOPS, "default": PEAK_TF32_FLOPS,
         "bfloat16": PEAK_BF16_FLOPS}
ELEMENT_BYTES = {"highest": 4, "default": 4, "bfloat16": 2}


@dataclass(frozen=True)
class Conv:
    name: str
    n: int
    cin: int
    cout: int
    h_in: int
    w_in: int
    k: int
    stride: int
    h_out: int
    w_out: int
    input_grad: bool  # whether training back-propagates into its input

    @property
    def flops(self) -> int:
        return 2 * self.n * self.cout * self.h_out * self.w_out * self.cin \
            * self.k * self.k

    def bytes(self, elem: int) -> int:
        """Input, weights and output, each read or written once."""
        return elem * (self.n * self.cin * self.h_in * self.w_in
                       + self.cout * self.cin * self.k * self.k
                       + self.n * self.cout * self.h_out * self.w_out)


@dataclass(frozen=True)
class BiLSTM:
    t: int       # steps
    n: int       # sequences a direction
    n_in: int
    hidden: int  # a direction

    @property
    def flops(self) -> int:
        return 2 * 2 * self.t * self.n * 4 * self.hidden * (self.n_in
                                                            + self.hidden)


def _half(v: int) -> int:
    """Output size of a 3x3, stride 2, padding 1 convolution."""
    return (v - 1) // 2 + 1


def base_net(name, n, nin, nout, f, t, nin_lstm, nout_lstm, input_grad):
    """(convs, lstm, dense (rows, in, out), resize lerp outputs) of one
    BaseNet on an (n, nin, f, t) input."""
    convs, resize = [], 0

    def conv(label, cin, cout, h, w, k=3, stride=1, grad=True):
        ho, wo = (_half(h), _half(w)) if stride == 2 else (h, w)
        convs.append(Conv(f"{name}.{label}", n, cin, cout, h, w, k, stride,
                          ho, wo, grad))
        return ho, wo

    h1 = conv("enc1", nin, nout, f, t, grad=input_grad)
    h2 = conv("enc2.conv1", nout, 2 * nout, *h1, stride=2)
    conv("enc2.conv2", 2 * nout, 2 * nout, *h2)
    h3 = conv("enc3.conv1", 2 * nout, 4 * nout, *h2, stride=2)
    conv("enc3.conv2", 4 * nout, 4 * nout, *h3)
    h4 = conv("enc4.conv1", 4 * nout, 6 * nout, *h3, stride=2)
    conv("enc4.conv2", 6 * nout, 6 * nout, *h4)
    h5 = conv("enc5.conv1", 6 * nout, 8 * nout, *h4, stride=2)
    conv("enc5.conv2", 8 * nout, 8 * nout, *h5)
    c = 8 * nout
    conv("aspp.conv1", c, c, 1, h5[1], k=1)  # on the frequency-pooled map
    conv("aspp.conv2", c, c, *h5, k=1)
    for i in (3, 4, 5):
        conv(f"aspp.conv{i}", c, c, *h5)
    conv("aspp.bottleneck", 5 * c, c, *h5, k=1)

    def up(ch, hw):  # 2x lerp along frequency, then along time
        return 3 * n * ch * (2 * hw[0] * hw[1] + 4 * hw[0] * hw[1])

    resize += up(c, h5)
    conv("dec4", c + 6 * nout, 6 * nout, *h4)
    resize += up(6 * nout, h4)
    conv("dec3", 10 * nout, 4 * nout, *h3)
    resize += up(4 * nout, h3)
    conv("dec2", 6 * nout, 2 * nout, *h2)
    conv("lstm_dec2.conv", 2 * nout, 1, *h2, k=1)
    lstm = BiLSTM(h2[1], n, nin_lstm, nout_lstm // 2)
    dense = (h2[1] * n, nout_lstm, nin_lstm)
    resize += up(2 * nout + 1, h2)
    conv("dec1", 3 * nout + 1, nout, *h1)
    return convs, lstm, dense, resize


def model_parts(config: dict, n: int, crop: int):
    """(convs, lstms, denses, resize lerp outputs) of one eval forward of
    the CascadedNet of `config` on an (n, 2, bins, crop) batch."""
    nout, nl = config["nout"], config["nout_lstm"]
    max_bin = config["n_fft"] // 2
    band, nin_lstm = max_bin // 2, max_bin // 2
    nets = [
        ("stg1_low", 2, nout // 2, band, nin_lstm // 2, nl, False),
        ("stg1_high", 2, nout // 4, band, nin_lstm // 2, nl // 2, False),
        ("stg2_low", nout // 4 + 2, nout, band, nin_lstm // 2, nl, True),
        ("stg2_high", nout // 4 + 2, nout // 2, band, nin_lstm // 2, nl // 2,
         True),
        ("stg3_full", 3 * nout // 4 + 2, nout, max_bin, nin_lstm, nl, True),
    ]
    convs, lstms, denses, resize = [], [], [], 0
    for name, nin, c, f, n_in_lstm, n_out_lstm, grad in nets:
        cv, lstm, dense, rs = base_net(name, n, nin, c, f, crop, n_in_lstm,
                                       n_out_lstm, grad)
        convs += cv
        lstms.append(lstm)
        denses.append(dense)
        resize += rs
        if name in ("stg1_low", "stg2_low"):  # the 1x1 squeeze after it
            convs.append(Conv(f"{name}.squeeze", n, c, c // 2, f, crop, 1, 1,
                              f, crop, True))
    convs.append(Conv("out", n, nout, 2, max_bin, crop, 1, 1, max_bin, crop,
                      True))
    return convs, lstms, denses, resize


def forward_flops(config: dict, n: int, crop: int) -> dict:
    """Useful operations of one eval forward, by kind and in total."""
    convs, lstms, denses, resize = model_parts(config, n, crop)
    out = {"conv": sum(c.flops for c in convs),
           "lstm": sum(l.flops for l in lstms),
           "dense": sum(2 * r * i * o for r, i, o in denses),
           "resize": resize}
    out["total"] = sum(out.values())
    return out


def train_flops(config: dict, n: int, crop: int) -> dict:
    """Useful operations of one training step (forward, backward; the
    optimizer's elementwise update is not counted)."""
    convs, lstms, denses, resize = model_parts(config, n, crop)
    out = {"conv": sum(c.flops * (3 if c.input_grad else 2) for c in convs),
           "lstm": 3 * sum(l.flops for l in lstms),
           "dense": 3 * sum(2 * r * i * o for r, i, o in denses),
           "resize": 2 * resize}
    out["total"] = sum(out.values())
    return out


def conv_bound_s(config: dict, n: int, crop: int, precision: str,
                 train: bool = False) -> float:
    """Least time the card could take for the convolutions of one forward
    (with `train`, of one step: the forward and both gradient products),
    each bound by its operations or its bytes, whichever is slower."""
    peak, elem = PEAKS[precision], ELEMENT_BYTES[precision]
    total = 0.0
    for c in model_parts(config, n, crop)[0]:
        passes = (3 if c.input_grad else 2) if train else 1
        total += passes * max(c.flops / peak, c.bytes(elem) / PEAK_BYTES)
    return total


def recurrence_bound_s(t_len: int, two_n: int, hidden: int) -> float:
    """Least time of one launch of the BiLSTM recurrence kernel on xg
    (T, 2N, 4H): bytes of xg, w_hh and the output once, operations of the
    recurrent products and gate adds (transcendentals excluded), at the
    float32 rate. Frozen copy of chip_smoke.py `phase_recurrence`'s
    arithmetic."""
    n_bytes = 4 * (t_len * two_n * 4 * hidden + 2 * hidden * 4 * hidden
                   + t_len * two_n * hidden)
    n_ops = t_len * two_n * 4 * hidden * (2 * hidden + 1)
    return max(n_bytes / PEAK_BYTES, n_ops / PEAK_F32_FLOPS)


def recurrence_launches(config: dict, n: int, crop: int):
    """(T, 2N, H) of the five recurrence launches of one eval forward."""
    return [(l.t, 2 * l.n, l.hidden)
            for l in model_parts(config, n, crop)[1]]


def useful_patches(n_samples: int, config: dict, crop: int) -> int:
    """Patches a song of `n_samples` needs, without length buckets or a
    chunk's top-up: the published separator's count on the song alone."""
    n_frame = 1 + n_samples // config["hop_length"]
    roi = crop - 2 * config["offset"]
    return n_frame // roi + 1
