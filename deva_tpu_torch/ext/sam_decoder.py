"""SAM prompt encoder + mask decoder (and the HQ form of Light-HQ-SAM) as
torch modules.

Port of deva_tpu/ext/sam_decoder.py. The math is deva_tpu's SamDecoder
(its positional encoding, prompt embedding, two-way transformer, upscaling,
hypernetwork masks, and the HQ token with its multi-scale fusion, ordered
best-IoU first under multimask_output); the module tree and parameter names
are the original `segment_anything` / sam-hq layout, the one
deva_tpu/ext/sam_decoder.py:convert_original_sam_statedict reads:

  prompt_encoder.pe_layer.positional_encoding_gaussian_matrix   [2, 128]
  prompt_encoder.point_embeddings.{0..3}, not_a_point_embed, no_mask_embed
  prompt_encoder.mask_downscaling.{0,1,3,4,6}
  mask_decoder.{iou_token, mask_tokens}
  mask_decoder.transformer.layers.{i}.{self_attn, cross_attn_token_to_image,
      cross_attn_image_to_token}.{q,k,v,out}_proj, .norm{1..4}, .mlp.lin{1,2}
  mask_decoder.transformer.{final_attn_token_to_image, norm_final_attn}
  mask_decoder.output_upscaling.{0,1,3}
  mask_decoder.output_hypernetworks_mlps.{i}.layers.{0,1,2}
  mask_decoder.iou_prediction_head.layers.{0,1,2}
  HQ: mask_decoder.hf_token, hf_mlp.layers.{0,1,2},
      compress_vit_feat.{0,1,3}, embedding_encoder.{0,1,3},
      embedding_maskfeature.{0,1,3}

so a released MobileSAM or Light-HQ-SAM checkpoint loads with
load_state_dict(strict=True). The 2x2 stride-2 transposed convolutions are
nn.ConvTranspose2d, whose weight layout [I, O, 2, 2] is the one deva_tpu's
_conv_transpose_2x2 takes (sam_decoder.py:174-179).

Inference only, NCHW image embeddings [B, 256, 64, 64], f32. GELU is the
exact erf form.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from deva_tpu_torch.ext.tiny_vit import LayerNorm2d


@dataclasses.dataclass(frozen=True)
class SamDecoderConfig:
    """deva_tpu/ext/sam_decoder.py:32-58 (SAM's decoder widths; hq adds
    Light-HQ-SAM's HQ token, fed by TinyViT's vit_dim-wide early
    features)."""
    hidden_size: int = 256
    num_heads: int = 8
    num_layers: int = 2
    mlp_dim: int = 2048
    attention_downsample_rate: int = 2
    num_multimask_outputs: int = 3
    iou_head_depth: int = 3
    iou_head_hidden_dim: int = 256
    image_size: int = 1024
    image_embedding_size: int = 64
    mask_input_channels: int = 16
    num_pos_feats: int = 128
    layer_norm_eps: float = 1e-6
    hq: bool = False
    vit_dim: int = 160

    @property
    def num_mask_tokens(self) -> int:
        return self.num_multimask_outputs + 1


class Attention(nn.Module):
    """Downscaled multi-head attention (segment_anything's Attention)."""

    def __init__(self, hidden: int, heads: int, downsample: int = 1):
        super().__init__()
        internal = hidden // downsample
        self.heads = heads
        self.q_proj = nn.Linear(hidden, internal)
        self.k_proj = nn.Linear(hidden, internal)
        self.v_proj = nn.Linear(hidden, internal)
        self.out_proj = nn.Linear(internal, hidden)

    def _split(self, x):
        b, n, c = x.shape
        return x.view(b, n, self.heads, c // self.heads).transpose(1, 2)

    def forward(self, q, k, v):  # [B, N, C]
        q = self._split(self.q_proj(q))
        k = self._split(self.k_proj(k))
        v = self._split(self.v_proj(v))
        attn = (q @ k.transpose(-2, -1)) * (q.shape[-1] ** -0.5)
        out = attn.softmax(dim=-1) @ v
        b, h, n, d = out.shape
        return self.out_proj(out.transpose(1, 2).reshape(b, n, h * d))


class MLPBlock(nn.Module):
    def __init__(self, hidden: int, mlp_dim: int):
        super().__init__()
        self.lin1 = nn.Linear(hidden, mlp_dim)
        self.lin2 = nn.Linear(mlp_dim, hidden)

    def forward(self, x):
        return self.lin2(F.relu(self.lin1(x)))


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, c: SamDecoderConfig, skip_first_layer_pe: bool):
        super().__init__()
        h, eps = c.hidden_size, c.layer_norm_eps
        self.self_attn = Attention(h, c.num_heads)
        self.norm1 = nn.LayerNorm(h, eps=eps)
        self.cross_attn_token_to_image = Attention(
            h, c.num_heads, c.attention_downsample_rate)
        self.norm2 = nn.LayerNorm(h, eps=eps)
        self.mlp = MLPBlock(h, c.mlp_dim)
        self.norm3 = nn.LayerNorm(h, eps=eps)
        self.norm4 = nn.LayerNorm(h, eps=eps)
        self.cross_attn_image_to_token = Attention(
            h, c.num_heads, c.attention_downsample_rate)
        self.skip_first_layer_pe = skip_first_layer_pe

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(
            q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(
            k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, c: SamDecoderConfig):
        super().__init__()
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(c, skip_first_layer_pe=(i == 0))
            for i in range(c.num_layers))
        self.final_attn_token_to_image = Attention(
            c.hidden_size, c.num_heads, c.attention_downsample_rate)
        self.norm_final_attn = nn.LayerNorm(c.hidden_size, eps=1e-6)

    def forward(self, point_embedding, image_embedding, image_pe):
        """point_embedding [BP, T, C]; image_embedding/image_pe [BP, S*S,
        C] tokens."""
        queries, keys = point_embedding, image_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, image_pe)
        q, k = queries + point_embedding, keys + image_pe
        queries = self.norm_final_attn(
            queries + self.final_attn_token_to_image(q, k, keys))
        return queries, keys


class MLP(nn.Module):
    """segment_anything's MLP: `depth` linear layers, ReLU between."""

    def __init__(self, cin: int, hidden: int, cout: int, depth: int):
        super().__init__()
        dims = [cin] + [hidden] * (depth - 1)
        self.layers = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(dims, dims[1:] + [cout]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class PositionEmbeddingRandom(nn.Module):
    def __init__(self, num_pos_feats: int):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.randn(2, num_pos_feats))

    def forward(self, coords):
        """coords in [0, 1], [..., 2] -> [..., 2 * num_pos_feats]."""
        coords = 2.0 * coords - 1.0
        coords = (2.0 * math.pi) * (
            coords @ self.positional_encoding_gaussian_matrix)
        return torch.cat([torch.sin(coords), torch.cos(coords)], dim=-1)


class PromptEncoder(nn.Module):
    def __init__(self, c: SamDecoderConfig):
        super().__init__()
        h, mic = c.hidden_size, c.mask_input_channels
        self.cfg = c
        self.pe_layer = PositionEmbeddingRandom(c.num_pos_feats)
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, h)
                                              for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, h)
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, mic // 4, 2, 2), LayerNorm2d(mic // 4), nn.GELU(),
            nn.Conv2d(mic // 4, mic, 2, 2), LayerNorm2d(mic), nn.GELU(),
            nn.Conv2d(mic, h, 1))
        self.no_mask_embed = nn.Embedding(1, h)

    def image_pe(self):
        """The image-wide positional grid [S*S, C], row-major (y, x)."""
        s = self.cfg.image_embedding_size
        dev = self.pe_layer.positional_encoding_gaussian_matrix.device
        ax = (torch.arange(s, dtype=torch.float32, device=dev) + 0.5) / s
        y, x = torch.meshgrid(ax, ax, indexing="ij")
        return self.pe_layer(torch.stack([x, y], dim=-1)).reshape(s * s, -1)

    def embed_points(self, points, labels, pad: bool):
        """points [B, P, Np, 2] (pixels of the padded square), labels
        [B, P, Np] -> [B, P, Np(+1), C]."""
        points = points + 0.5
        if pad:
            points = torch.cat([points, points.new_zeros(
                (*points.shape[:2], 1, 2))], dim=2)
            labels = torch.cat([labels, -labels.new_ones(
                (*labels.shape[:2], 1))], dim=2)
        pe = self.pe_layer(points / self.cfg.image_size)
        lab = labels[..., None]
        pe = torch.where(lab == -1, self.not_a_point_embed.weight[0], pe)
        pe = torch.where(lab == -10, torch.zeros_like(pe), pe)
        pe = torch.where(lab == 0, pe + self.point_embeddings[0].weight[0],
                         pe)
        return torch.where(lab == 1, pe + self.point_embeddings[1].weight[0],
                           pe)

    def embed_boxes(self, boxes):
        """boxes [B, P, 4] (x1, y1, x2, y2) -> corner embeddings
        [B, P, 2, C]."""
        corners = (boxes.reshape(*boxes.shape[:2], 2, 2) + 0.5) / \
            self.cfg.image_size
        pe = self.pe_layer(corners)
        return torch.stack([pe[:, :, 0] + self.point_embeddings[2].weight[0],
                            pe[:, :, 1] + self.point_embeddings[3].weight[0]],
                           dim=2)

    def embed_mask(self, mask):  # [B, 1, 4S, 4S] -> [B, C, S, S]
        return self.mask_downscaling(mask)


class MaskDecoder(nn.Module):
    def __init__(self, c: SamDecoderConfig):
        super().__init__()
        h = c.hidden_size
        self.cfg = c
        self.transformer = TwoWayTransformer(c)
        self.iou_token = nn.Embedding(1, h)
        self.mask_tokens = nn.Embedding(c.num_mask_tokens, h)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(h, h // 4, 2, 2), LayerNorm2d(h // 4),
            nn.GELU(), nn.ConvTranspose2d(h // 4, h // 8, 2, 2), nn.GELU())
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLP(h, h, h // 8, 3) for _ in range(c.num_mask_tokens))
        self.iou_prediction_head = MLP(h, c.iou_head_hidden_dim,
                                       c.num_mask_tokens, c.iou_head_depth)
        if c.hq:
            self.hf_token = nn.Embedding(1, h)
            self.hf_mlp = MLP(h, h, h // 8, 3)
            # early TinyViT features [.., vit_dim] -> C/8 at 4x
            self.compress_vit_feat = nn.Sequential(
                nn.ConvTranspose2d(c.vit_dim, h, 2, 2), LayerNorm2d(h),
                nn.GELU(), nn.ConvTranspose2d(h, h // 8, 2, 2))
            # final image embeddings -> C/8 at 4x
            self.embedding_encoder = nn.Sequential(
                nn.ConvTranspose2d(h, h // 4, 2, 2), LayerNorm2d(h // 4),
                nn.GELU(), nn.ConvTranspose2d(h // 4, h // 8, 2, 2))
            # refines the upscaled SAM embedding
            self.embedding_maskfeature = nn.Sequential(
                nn.Conv2d(h // 8, h // 4, 3, 1, 1), LayerNorm2d(h // 4),
                nn.GELU(), nn.Conv2d(h // 4, h // 8, 3, 1, 1))


class SamDecoder(nn.Module):
    """Prompt encoder + two-way mask decoder.

    forward(image_embeddings [B, C, S, S], points [B, P, Np, 2] / labels
    [B, P, Np] and/or boxes [B, P, 4] (pixels of the padded square),
    mask_input [B, 1, 4S, 4S] or None, multimask_output,
    intermediate_embeddings [B, vit_dim, S, S] (HQ), hq_token_only)
      -> (mask logits [B, P, n, 4S, 4S], iou_pred [B, P, n]); n is 3 with
    multimask_output, else 1."""

    def __init__(self, cfg: SamDecoderConfig = SamDecoderConfig()):
        super().__init__()
        self.cfg = cfg
        self.prompt_encoder = PromptEncoder(cfg)
        self.mask_decoder = MaskDecoder(cfg)

    def forward(self, image_embeddings, points=None, labels=None, boxes=None,
                mask_input=None, multimask_output: bool = True,
                intermediate_embeddings=None, hq_token_only: bool = False):
        c = self.cfg
        pe_mod, md = self.prompt_encoder, self.mask_decoder
        b, ch, s, _ = image_embeddings.shape

        sparse = None
        if points is not None:
            sparse = pe_mod.embed_points(points, labels, pad=boxes is None)
        if boxes is not None:
            be = pe_mod.embed_boxes(boxes)
            sparse = be if sparse is None else torch.cat([sparse, be], dim=2)
        if sparse is None:
            raise ValueError("points and/or boxes required")
        p = sparse.shape[1]  # prompts per image

        if mask_input is not None:
            dense = pe_mod.embed_mask(mask_input)
        else:
            dense = pe_mod.no_mask_embed.weight[0][None, :, None, None]

        out_tokens = [md.iou_token.weight, md.mask_tokens.weight]
        if c.hq:
            out_tokens.append(md.hf_token.weight)
        out_tokens = torch.cat(out_tokens, dim=0)
        n_tok = out_tokens.shape[0] - 1
        tokens = torch.cat([out_tokens.expand(b, p, *out_tokens.shape),
                            sparse], dim=2).reshape(b * p, -1, ch)

        # the image tokens and their positional grid, per prompt
        img = (image_embeddings + dense).flatten(2).transpose(1, 2)
        img = img[:, None].expand(b, p, s * s, ch).reshape(b * p, s * s, ch)
        pe = pe_mod.image_pe()[None].expand(b * p, s * s, ch)

        queries, keys = md.transformer(tokens, img, pe)
        iou_token_out = queries[:, 0]
        mask_tokens_out = queries[:, 1:1 + n_tok]

        up = md.output_upscaling(keys.transpose(1, 2).reshape(b * p, ch, s,
                                                              s))
        hyper = [md.output_hypernetworks_mlps[i](mask_tokens_out[:, i])
                 for i in range(c.num_mask_tokens)]
        if c.hq:
            hyper.append(md.hf_mlp(mask_tokens_out[:, c.num_mask_tokens]))
        hyper = torch.stack(hyper, dim=1)  # [BP, M(+1), C/8]
        masks = torch.einsum("bmc,bchw->bmhw", hyper[:, :c.num_mask_tokens],
                             up).reshape(b, p, c.num_mask_tokens, 4 * s,
                                         4 * s)
        iou_pred = md.iou_prediction_head(iou_token_out).reshape(
            b, p, c.num_mask_tokens)

        if not c.hq:
            sl = slice(1, None) if multimask_output else slice(0, 1)
            return masks[:, :, sl], iou_pred[:, :, sl]

        # HQ: refine the upscaled embedding with the multi-scale vision
        # features and predict the HQ mask from the HQ token
        hq_feat = md.embedding_encoder(image_embeddings)
        if intermediate_embeddings is not None:
            hq_feat = hq_feat + md.compress_vit_feat(intermediate_embeddings)
        up_hq = md.embedding_maskfeature(up)
        up_hq = up_hq + hq_feat.repeat_interleave(p, dim=0)
        mask_hq = torch.einsum("bmc,bchw->bmhw", hyper[:, c.num_mask_tokens:],
                               up_hq).reshape(b, p, 1, 4 * s, 4 * s)

        if multimask_output:
            # the 3 multimask channels, best IoU first (a stable order)
            iou_mm = iou_pred[:, :, 1:c.num_mask_tokens]
            order = torch.argsort(-iou_mm, dim=-1, stable=True)
            masks_sam = torch.take_along_dim(
                masks[:, :, 1:c.num_mask_tokens], order[..., None, None],
                dim=2)
            iou_out = torch.take_along_dim(iou_mm, order, dim=-1)
        else:
            masks_sam = masks[:, :, 0:1]
            iou_out = iou_pred[:, :, 0:1]
        out = mask_hq if hq_token_only else masks_sam + mask_hq
        return out, iou_out


def init_sam_weights(module: nn.Module, seed: int = 0) -> nn.Module:
    """A seeded random init of a SAM module (any of TinyViT, SamDecoder,
    the MobileSAM network) that gives every parameter and buffer a scale of
    its own, where torch's default init leaves the norms at 1 and 0 and the
    BatchNorm statistics at 0 and 1: weights normal with std
    1/sqrt(fan-in), biases, norm shifts and running means normal(0, 0.1),
    norm scales and running variances uniform(0.5, 1.5), embeddings and
    the positional Gaussian normal(0, 1), TinyViT's attention biases
    normal(0, 0.5). Drawn on the CPU, so a seed gives the same weights on
    every device."""
    g = torch.Generator().manual_seed(seed)
    norms = (nn.BatchNorm2d, nn.LayerNorm, LayerNorm2d)

    def normal(t, std):
        t.copy_(torch.randn(t.shape, generator=g) * std)

    def uniform(t, lo=0.5, hi=1.5):
        t.copy_(torch.rand(t.shape, generator=g) * (hi - lo) + lo)

    with torch.no_grad():
        for name, t in module.state_dict(keep_vars=True).items():
            owner_name, _, leaf = name.rpartition(".")
            owner = module.get_submodule(owner_name)
            if leaf == "num_batches_tracked":
                continue
            if isinstance(owner, nn.Embedding) or \
                    leaf == "positional_encoding_gaussian_matrix":
                normal(t, 1.0)
            elif leaf == "attention_biases":
                normal(t, 0.5)
            elif leaf in ("bias", "running_mean"):
                normal(t, 0.1)
            elif isinstance(owner, norms):  # scales, running variances
                uniform(t)
            elif isinstance(owner, nn.ConvTranspose2d):  # [I, O, 2, 2]
                normal(t, t.shape[0] ** -0.5)
            else:  # Linear [O, I], Conv2d [O, I/g, kh, kw]
                normal(t, t[0].numel() ** -0.5)
    return module
