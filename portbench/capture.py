"""Hooks that record, for each picture of a traced window, what the
kernel bounds (``bounds/``) count: its size, its intra and inter MBs,
its coded luma blocks, the route the decoder gave it and, on the GOP
kernel's route, its payload.  Each runs after the program's call
returns, outside the call's span; they read the program's host arrays
and touch no device memory."""
from __future__ import annotations


def parsed(args, kwargs, result, pictures):
    """After ``SliceDecoder.decode_slice_data``: a picture whose every MB
    is parsed is recorded once."""
    sd = args[0].sd
    if (sd.mb_kind < 0).any():
        return
    if pictures and pictures[-1].get("_sd") is sd:
        return
    kind = sd.mb_kind
    pictures.append({
        "_sd": sd, "gw": sd.gw, "gh": sd.gh, "route": None,
        "n_intra": int(((kind == 0) | (kind == 1)).sum()),
        "n_inter": int((kind >= 3).sum()),
        "n_i16": int((kind == 1).sum()),
        "coded_luma_blocks": int((sd.nnz_luma > 0).sum())})


def kernel_route(args, kwargs, result, pictures):
    """After ``d_pool.pack_fast``: the picture takes the GOP kernel with
    this payload (a ``FastFrame``)."""
    if pictures:
        p = pictures[-1]
        p["route"] = "kernel"
        p["smb_bytes"] = int(result.smb.size) * 4
        p["aux_bytes"] = int(result.aux.nbytes)
        p["nr"] = int(result.tags.shape[0])
        p["ni"] = int(result.ilist.shape[0])


def scan_route(args, kwargs, result, pictures):
    """After ``pack_slice_rows``: the picture takes the GOP scan."""
    if pictures:
        pictures[-1]["route"] = "scan"


DECODE_HOOKS = {
    "hartallo_tpu_torch.decode.slice_decode:SliceDecoder.decode_slice_data":
        parsed,
    "hartallo_tpu_torch.decode.d_pool:pack_fast": kernel_route,
    "hartallo_tpu_torch.decode.decoder:pack_slice_rows": scan_route,
}
