"""Algebraic folds that remove whole passes from the inference program.

``fold_tf_preprocess``: the 'tf' preprocessing mode (x/127.5 - 1, used by
InceptionV3/Xception) is an affine map, and the stem is conv(VALID) ->
BatchNorm, both linear in x. So the preprocessing folds exactly into the
stem weights:

    conv(x/127.5 - 1, W) = conv(x, W/127.5) - S,   S[o] = sum W[o, ...]
    BN eval subtracts the running mean, so mean' = mean + S absorbs S.

(VALID padding matters: a constant input yields the same S at every output
position only when no zero padding enters the window.) After folding, the
model consumes raw [0, 255] pixels directly — one full-image elementwise
pass gone, and the stem kernel reads the pixels as they come.
"""

from __future__ import annotations


def fold_tf_preprocess(state_dict: dict, conv: str = "conv000",
                       bn: str = "bn000") -> dict:
    """Return a new ``state_dict`` with 'tf'-mode preprocessing folded into
    the stem conv + BN. The model must then be fed RAW [0,255] pixels with
    the identity preprocessor.

    Asserted here: the stem conv is bias-free and the BN has a running
    mean. NOT checkable from the weights alone (the caller must guarantee
    it): the stem conv uses VALID padding — with SAME padding the "-1"
    response is position-dependent at the borders and this fold is
    silently wrong. Both zoo 'tf'-mode stems (InceptionV3, Xception) are
    VALID.
    """
    if f"{conv}.weight" not in state_dict:
        raise ValueError(f"no stem conv {conv!r} in state_dict")
    if f"{conv}.bias" in state_dict:
        raise ValueError(
            f"stem conv {conv!r} has a bias; fold expects the zoo's "
            "bias-free conv+BN stem"
        )
    if f"{bn}.running_mean" not in state_dict:
        raise ValueError(f"no running mean for {bn!r} in state_dict")

    orig = state_dict[f"{conv}.weight"]  # OIHW
    out = dict(state_dict)
    out[f"{conv}.weight"] = orig / 127.5
    # S[o]: the stem's response to the "-1" term rides the ORIGINAL
    # kernel scale — conv(x/127.5 - 1, W) = conv(x, W/127.5) - sum(W)
    out[f"{bn}.running_mean"] = (
        state_dict[f"{bn}.running_mean"] + orig.sum(dim=(1, 2, 3))
    )
    return out
