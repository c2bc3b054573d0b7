"""Whisper-family ASR in PyTorch: log-mel frontend, audio encoder, decoder
with an explicit KV cache, greedy decoding.

The counterpart of `distributed_crawler_tpu/models/whisper.py`, with the
same configs, presets, module names and numerics:

- Dense and conv weights are held in the activation dtype (bf16 for the
  published presets) and add their bias in that dtype after the product,
  as flax casts its f32 params at every call; LayerNorms (eps 1e-5) and the
  decoder's token and position tables stay f32;
- pre-LN layers with f32 residual adds; exact (erf) GELU in the MLP and
  the conv stem;
- the conv stem pads as flax's ``padding="SAME"`` does: (1, 1) for
  ``conv1`` and, for ``conv2`` (stride 2 over an even frame count),
  **(0, 1)** — not the (1, 1) of the published ``Conv1d(padding=1)``;
- the audio encoder's self-attention has no mask and goes through
  `ops.attention.flash_attention` (the hand-written kernel for a CUDA
  tensor, the plain `attend` for a CPU one); the decoder's self- and
  cross-attention are `_attend`, plain PyTorch, as the reference computes
  them in XLA: bf16 logits cast to f32 and scaled, masked entries set to
  the finite -1e30 (a fully masked row comes out uniform), softmax in f32,
  probabilities cast to the input dtype before PV;
- the log-mel frontend runs in f32 on the device of its input, with the
  reference's Hann window and Slaney filterbank as numpy constants;
- greedy decoding is the reference's static-length scan as a Python loop
  over decode steps: the prompt ``[sot, transcribe, no_timestamps]`` is
  forced, tokens after EOT are EOT, and the loop may stop once every row
  has finished, which changes no token.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import torch_dtype
from ..ops.attention import flash_attention
from .encoder import Dense

SAMPLE_RATE = 16_000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_SECONDS = 30
N_SAMPLES = SAMPLE_RATE * CHUNK_SECONDS          # 480_000
N_FRAMES = N_SAMPLES // HOP_LENGTH               # 3000

# Steps between checks that every row has emitted EOT (each check waits
# for the device).
_FINISHED_CHECK_STEPS = 16


@dataclass(frozen=True)
class WhisperConfig:
    n_mels: int = 80
    n_vocab: int = 51_865
    n_audio_ctx: int = 1500          # mel frames / 2 (conv stride)
    n_audio_state: int = 768
    n_audio_head: int = 12
    n_audio_layer: int = 12
    n_text_ctx: int = 448
    n_text_state: int = 768
    n_text_head: int = 12
    n_text_layer: int = 12
    dtype: str = "bfloat16"
    # Special tokens (multilingual vocab layout).
    sot_token: int = 50_258          # <|startoftranscript|>
    eot_token: int = 50_257          # <|endoftext|>
    no_timestamps_token: int = 50_363
    transcribe_token: int = 50_359

    @property
    def adtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def audio_head_dim(self) -> int:
        return self.n_audio_state // self.n_audio_head

    @property
    def text_head_dim(self) -> int:
        return self.n_text_state // self.n_text_head


WHISPER_TINY = WhisperConfig(n_audio_state=384, n_audio_head=6,
                             n_audio_layer=4, n_text_state=384,
                             n_text_head=6, n_text_layer=4)
WHISPER_BASE = WhisperConfig(n_audio_state=512, n_audio_head=8,
                             n_audio_layer=6, n_text_state=512,
                             n_text_head=8, n_text_layer=6)
WHISPER_SMALL = WhisperConfig()  # 768/12/12 — BASELINE config #4
# Test config: tiny everything, short audio context, f32 on CPU.
WHISPER_TEST = WhisperConfig(n_mels=8, n_vocab=128, n_audio_ctx=16,
                             n_audio_state=32, n_audio_head=4,
                             n_audio_layer=2, n_text_ctx=12, n_text_state=32,
                             n_text_head=4, n_text_layer=2, dtype="float32",
                             sot_token=1, eot_token=2, no_timestamps_token=3,
                             transcribe_token=4)


# -- log-mel frontend --------------------------------------------------------
def _mel_filterbank(n_mels: int, n_fft: int = N_FFT,
                    sample_rate: int = SAMPLE_RATE) -> np.ndarray:
    """Slaney-scale triangular mel filterbank [n_mels, n_fft//2+1], f32:
    ``librosa.filters.mel`` defaults (htk=False, norm="slaney"), linear
    below 1 kHz and logarithmic above."""
    f_sp = 200.0 / 3.0            # Hz per mel in the linear region
    min_log_hz = 1000.0           # linear/log crossover
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0  # step above the crossover

    def hz_to_mel(f):
        f = np.asarray(f, dtype=np.float64)
        return np.where(f < min_log_hz, f / f_sp,
                        min_log_mel + np.log(np.maximum(f, min_log_hz)
                                             / min_log_hz) / logstep)

    def mel_to_hz(m):
        m = np.asarray(m, dtype=np.float64)
        return np.where(m < min_log_mel, m * f_sp,
                        min_log_hz * np.exp(logstep * (m - min_log_mel)))

    n_freqs = n_fft // 2 + 1
    freqs = np.linspace(0, sample_rate / 2, n_freqs)
    mel_pts = np.linspace(hz_to_mel(0.0), hz_to_mel(sample_rate / 2),
                          n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    bank = np.zeros((n_mels, n_freqs), dtype=np.float32)
    for i in range(n_mels):
        lo, ctr, hi = hz_pts[i], hz_pts[i + 1], hz_pts[i + 2]
        up = (freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - freqs) / max(hi - ctr, 1e-10)
        bank[i] = np.maximum(0.0, np.minimum(up, down))
    # Slaney area normalization.
    enorm = 2.0 / (hz_pts[2:] - hz_pts[:-2])
    bank *= enorm[:, None]
    return bank


def _hann(n_fft: int) -> np.ndarray:
    """The periodic Hann window, f32."""
    return np.hanning(n_fft + 1)[:-1].astype(np.float32)


def pad_or_trim(audio: torch.Tensor, n_samples: int = N_SAMPLES
                ) -> torch.Tensor:
    """Fixed window: trim or zero-pad the last axis to ``n_samples``."""
    length = audio.shape[-1]
    if length > n_samples:
        return audio[..., :n_samples]
    if length < n_samples:
        return F.pad(audio, (0, n_samples - length))
    return audio


def log_mel_spectrogram(audio: torch.Tensor, n_mels: int = 80,
                        n_fft: int = N_FFT,
                        hop: int = HOP_LENGTH) -> torch.Tensor:
    """waveform [.., T] (16 kHz) -> log-mel [.., T // hop, n_mels], f32.

    Reflect pad of ``n_fft // 2`` (numpy's ``reflect``), exactly
    ``T // hop`` frames (the one more that a centred STFT gives is not
    taken), Hann window, rfft, power, mel, log10, a clamp at each
    example's maximum - 8, then (x + 4) / 4."""
    audio = audio.float()
    lead, t = audio.shape[:-1], audio.shape[-1]
    pad = n_fft // 2
    x = F.pad(audio.reshape(1, -1, t), (pad, pad), mode="reflect")
    x = x.reshape(*lead, t + 2 * pad)
    n_frames = t // hop
    window = torch.from_numpy(_hann(n_fft)).to(audio.device)
    frames = x.unfold(-1, n_fft, hop)[..., :n_frames, :] * window
    power = torch.fft.rfft(frames, dim=-1).abs() ** 2
    mel = torch.from_numpy(_mel_filterbank(n_mels, n_fft)).to(audio.device)
    mspec = torch.einsum("...fk,mk->...fm", power, mel)
    log_spec = torch.log10(torch.clamp(mspec, min=1e-10))
    peak = log_spec.amax(dim=(-2, -1), keepdim=True)
    log_spec = torch.maximum(log_spec, peak - 8.0)
    return (log_spec + 4.0) / 4.0


# -- attention ---------------------------------------------------------------
def _sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's fixed sinusoidal positions [length, channels], f32."""
    log_timescale = np.log(10_000) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)],
                          axis=1).astype(np.float32)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The reference's Whisper attention.  q [B,Tq,H,D], k/v [B,Tk,H,D];
    ``mask`` broadcastable to [B,H,Tq,Tk] (True = attend).  The logits are
    a product in the input dtype, then f32 and scaled; masked entries are
    -1e30, so a fully masked row is uniform."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if mask is not None:
        logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


Cache = List[Tuple[torch.Tensor, torch.Tensor]]


class MHA(nn.Module):
    """Projections of one attention block; the key projection has no bias.
    ``kernel=True`` (the audio encoder) sends the unmasked self-attention
    to `flash_attention`; otherwise it is `_attend`."""

    def __init__(self, n_state: int, n_head: int, dtype: torch.dtype,
                 kernel: bool = False):
        super().__init__()
        self.n_head = n_head
        self.kernel = kernel
        self.q = Dense(n_state, n_state, dtype=dtype)
        self.k = Dense(n_state, n_state, bias=False, dtype=dtype)
        self.v = Dense(n_state, n_state, dtype=dtype)
        self.attn_out = Dense(n_state, n_state, dtype=dtype)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        b, t, s = x.shape
        return x.reshape(b, t, self.n_head, s // self.n_head)

    def forward(self, x: torch.Tensor, xa: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Full-sequence attention: self when ``xa`` is None, else cross."""
        src = x if xa is None else xa
        q = self._split(self.q(x))
        k = self._split(self.k(src))
        v = self._split(self.v(src))
        if self.kernel and xa is None and mask is None:
            o = flash_attention(q, k, v)
        else:
            o = _attend(q, k, v, mask)
        return self.attn_out(o.reshape(x.shape))

    def project_kv(self, xa: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Cross-attention K/V, once per utterance."""
        return self._split(self.k(xa)), self._split(self.v(xa))

    def step(self, x_t: torch.Tensor, cache_k: Optional[torch.Tensor],
             cache_v: Optional[torch.Tensor], pos: int,
             cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One decode step, x_t [B, 1, S].  Self-attention writes its K/V
        into the cache tensors at ``pos``, in place, and attends to the
        whole cache under ``mask`` (positions <= pos; made here when not
        given).  With ``cross_kv`` it attends to those, unmasked."""
        q = self._split(self.q(x_t))
        if cross_kv is not None:
            k, v = cross_kv
            o = _attend(q, k, v)
        else:
            cache_k[:, pos] = self._split(self.k(x_t))[:, 0]
            cache_v[:, pos] = self._split(self.v(x_t))[:, 0]
            if mask is None:
                mask = causal_step_mask(cache_k.shape[1], pos, x_t.device)
            o = _attend(q, cache_k, cache_v, mask)
        return self.attn_out(o.reshape(x_t.shape))


def causal_step_mask(n_ctx: int, pos: int,
                     device: torch.device) -> torch.Tensor:
    """[1, 1, 1, n_ctx]: True at cache positions <= pos."""
    return (torch.arange(n_ctx, device=device) <= pos)[None, None, None, :]


class MLP(nn.Module):
    def __init__(self, n_state: int, dtype: torch.dtype):
        super().__init__()
        self.mlp_up = Dense(n_state, 4 * n_state, dtype=dtype)
        self.mlp_down = Dense(4 * n_state, n_state, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp_down(F.gelu(self.mlp_up(x)))


def _ln(n: int) -> nn.LayerNorm:
    return nn.LayerNorm(n, eps=1e-5)  # f32


class Conv1d(nn.Conv1d):
    """flax ``nn.Conv`` twin on [B, C, T]: ``padding="SAME"`` (for stride
    s: ceil(T / s) outputs, the padding split with the smaller half in
    front), the bias added after the product in the weight's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, k, s = x.shape[-1], self.kernel_size[0], self.stride[0]
        total = max((-(-n // s) - 1) * s + k - n, 0)
        x = F.pad(x, (total // 2, total - total // 2))
        return F.conv1d(x, self.weight, stride=s) + self.bias[:, None]


# -- audio encoder -----------------------------------------------------------
class AudioEncoderLayer(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        self.cfg = cfg
        self.attn = MHA(cfg.n_audio_state, cfg.n_audio_head, cfg.adtype,
                        kernel=True)
        self.mlp = MLP(cfg.n_audio_state, cfg.adtype)
        self.ln_attn = _ln(cfg.n_audio_state)
        self.ln_mlp = _ln(cfg.n_audio_state)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        adt = self.cfg.adtype
        a = self.attn(self.ln_attn(x.float()).to(adt))
        x = x.float() + a.float()
        m = self.mlp(self.ln_mlp(x).to(adt))
        return (x + m.float()).to(adt)


class AudioEncoder(nn.Module):
    """mel [B, n_frames, n_mels] -> audio features [B, n_audio_ctx, S]."""

    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        self.cfg = cfg
        s, adt = cfg.n_audio_state, cfg.adtype
        self.conv1 = Conv1d(cfg.n_mels, s, 3, stride=1, dtype=adt)
        self.conv2 = Conv1d(s, s, 3, stride=2, dtype=adt)
        self.register_buffer("positions", torch.from_numpy(
            _sinusoids(cfg.n_audio_ctx, s)).to(adt), persistent=False)
        self.layers = nn.ModuleList(AudioEncoderLayer(cfg)
                                    for _ in range(cfg.n_audio_layer))
        self.ln_post = _ln(s)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        adt = self.cfg.adtype
        x = F.gelu(self.conv1(mel.to(adt).transpose(1, 2)))
        x = F.gelu(self.conv2(x)).transpose(1, 2).contiguous()
        x = x + self.positions[:x.shape[1]]
        for layer in self.layers:
            x = layer(x)
        return self.ln_post(x.float()).to(adt)


# -- text decoder ------------------------------------------------------------
class DecoderLayer(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        self.cfg = cfg
        s, h, adt = cfg.n_text_state, cfg.n_text_head, cfg.adtype
        self.attn = MHA(s, h, adt)
        self.cross_attn = MHA(s, h, adt)
        self.mlp = MLP(s, adt)
        self.ln_attn = _ln(s)
        self.ln_cross = _ln(s)
        self.ln_mlp = _ln(s)

    def _rest(self, x: torch.Tensor, a: torch.Tensor, cross) -> torch.Tensor:
        """Residual after self-attention, cross-attention, MLP."""
        adt = self.cfg.adtype
        x = x.float() + a.float()
        x = x + cross(self.ln_cross(x).to(adt)).float()
        m = self.mlp(self.ln_mlp(x).to(adt))
        return (x + m.float()).to(adt)

    def forward(self, x: torch.Tensor, xa: torch.Tensor,
                causal_mask: torch.Tensor) -> torch.Tensor:
        """Teacher forcing over the whole sequence."""
        a = self.attn(self.ln_attn(x.float()).to(self.cfg.adtype),
                      mask=causal_mask)
        return self._rest(x, a, lambda h: self.cross_attn(h, xa=xa))

    def step(self, x_t: torch.Tensor, cache: Tuple[torch.Tensor, torch.Tensor],
             pos: int, cross_kv: Tuple[torch.Tensor, torch.Tensor],
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        a = self.attn.step(self.ln_attn(x_t.float()).to(self.cfg.adtype),
                           cache[0], cache[1], pos, mask=mask)
        return self._rest(x_t, a, lambda h: self.cross_attn.step(
            h, None, None, pos, cross_kv=cross_kv))


class TextDecoder(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        self.cfg = cfg
        s = cfg.n_text_state
        self.embed_tokens = nn.Parameter(torch.empty(cfg.n_vocab, s))
        self.embed_positions = nn.Parameter(torch.empty(cfg.n_text_ctx, s))
        nn.init.normal_(self.embed_tokens, std=0.02)
        nn.init.normal_(self.embed_positions, std=0.02)
        self.layers = nn.ModuleList(DecoderLayer(cfg)
                                    for _ in range(cfg.n_text_layer))
        self.ln_post = _ln(s)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """Tied embedding projection, f32."""
        return torch.einsum("btd,vd->btv", self.ln_post(x.float()),
                            self.embed_tokens)

    def forward(self, tokens: torch.Tensor, xa: torch.Tensor
                ) -> torch.Tensor:
        """Teacher forcing: tokens [B, T] -> logits [B, T, V]."""
        t = tokens.shape[1]
        x = (self.embed_tokens[self._vocab_index(tokens)]
             + self.embed_positions[:t][None])
        x = x.to(self.cfg.adtype)
        causal = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                       device=x.device))[None, None]
        for layer in self.layers:
            x = layer(x, xa, causal)
        return self._logits(x)

    def _vocab_index(self, tokens: torch.Tensor) -> torch.Tensor:
        """Token ids clamped into the table, as JAX's gather clamps them: a
        special token past a small vocabulary reads the last row.  On the
        card an index out of range would be a device-side assert that
        leaves the process's CUDA context unusable."""
        return tokens.long().clamp(0, self.embed_tokens.shape[0] - 1)

    def init_cache(self, batch: int) -> Cache:
        c = self.cfg
        shape = (batch, c.n_text_ctx, c.n_text_head, c.text_head_dim)
        dev = self.embed_tokens.device
        return [(torch.zeros(shape, dtype=c.adtype, device=dev),
                 torch.zeros(shape, dtype=c.adtype, device=dev))
                for _ in range(c.n_text_layer)]

    def cross_kv(self, xa: torch.Tensor) -> Cache:
        return [layer.cross_attn.project_kv(xa) for layer in self.layers]

    def step(self, token_t: torch.Tensor, pos: int, cache: Cache,
             cross_kvs: Cache) -> Tuple[torch.Tensor, Cache]:
        """token_t [B, 1] at position ``pos`` -> (logits [B, V], cache);
        the cache tensors are updated in place."""
        x = (self.embed_tokens[self._vocab_index(token_t)]
             + self.embed_positions[pos][None, None])
        x = x.to(self.cfg.adtype)
        mask = causal_step_mask(self.cfg.n_text_ctx, pos, x.device)
        for layer, layer_cache, ckv in zip(self.layers, cache, cross_kvs):
            x = layer.step(x, layer_cache, pos, ckv, mask=mask)
        return self._logits(x)[:, 0, :], cache


class Whisper(nn.Module):
    """Encoder-decoder: ``forward`` is teacher forcing; `encode` and the
    ``decode_*`` methods drive greedy inference."""

    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = AudioEncoder(cfg)
        self.decoder = TextDecoder(cfg)

    def forward(self, mel: torch.Tensor, tokens: torch.Tensor
                ) -> torch.Tensor:
        return self.decoder(tokens, self.encoder(mel))

    def encode(self, mel: torch.Tensor) -> torch.Tensor:
        return self.encoder(mel)

    def decode_teacher(self, tokens: torch.Tensor, xa: torch.Tensor
                       ) -> torch.Tensor:
        return self.decoder(tokens, xa)

    def decode_init(self, batch: int, xa: torch.Tensor
                    ) -> Tuple[Cache, Cache]:
        return self.decoder.init_cache(batch), self.decoder.cross_kv(xa)

    def decode_step(self, token_t: torch.Tensor, pos: int, cache: Cache,
                    cross_kvs: Cache) -> Tuple[torch.Tensor, Cache]:
        return self.decoder.step(token_t, pos, cache, cross_kvs)


# -- greedy decoding ---------------------------------------------------------
@torch.inference_mode()
def greedy_decode(model: Whisper, mel: torch.Tensor,
                  max_len: Optional[int] = None) -> torch.Tensor:
    """mel [B, F, M] -> token ids [B, max_len] int32, EOT-padded: ``sot``,
    then ``max_len - 1`` decode steps, the prompt forced while ``pos + 1 <
    3``; after EOT a row emits EOT."""
    return greedy_decode_with_steps(model, mel, max_len)[0]


def greedy_decode_with_steps(model: Whisper, mel: torch.Tensor,
                             max_len: Optional[int] = None
                             ) -> Tuple[torch.Tensor, int]:
    """`greedy_decode`'s tokens and the decode steps it ran: ``max_len -
    1``, or fewer when every row has emitted EOT (checked every
    ``_FINISHED_CHECK_STEPS`` steps)."""
    cfg = model.cfg
    max_len = max_len or cfg.n_text_ctx
    batch = mel.shape[0]
    xa = model.encode(mel)
    cache, cross_kvs = model.decode_init(batch, xa)
    prompt = (cfg.sot_token, cfg.transcribe_token, cfg.no_timestamps_token)
    out = torch.full((batch, max_len), cfg.eot_token, dtype=torch.int32,
                     device=mel.device)
    out[:, 0] = cfg.sot_token
    token = out[:, :1].long()
    finished = torch.zeros(batch, dtype=torch.bool, device=mel.device)
    steps = 0
    for pos in range(max_len - 1):
        logits, cache = model.decode_step(token, pos, cache, cross_kvs)
        if pos + 1 < len(prompt):
            nxt = torch.full_like(finished, prompt[pos + 1],
                                  dtype=torch.long)
        else:
            nxt = torch.argmax(logits, dim=-1)
        nxt = torch.where(finished, cfg.eot_token, nxt)
        finished = finished | (nxt == cfg.eot_token)
        out[:, pos + 1] = nxt
        token = nxt[:, None]
        steps = pos + 1
        # Once every row has finished, the rest of ``out`` is EOT already.
        if steps % _FINISHED_CHECK_STEPS == 0 and bool(finished.all()):
            break
    return out, steps


def audio_window_samples(cfg: WhisperConfig) -> int:
    """The fixed waveform window of the audio context: n_audio_ctx
    positions x conv stride 2 x hop (30 s for the published configs)."""
    return cfg.n_audio_ctx * 2 * HOP_LENGTH


def transcribe_features(model: Whisper, audio: torch.Tensor,
                        max_len: Optional[int] = None) -> torch.Tensor:
    """waveform [B, T] -> token ids [B, L]: frontend, encoder, greedy."""
    return transcribe_features_with_steps(model, audio, max_len)[0]


def transcribe_features_with_steps(model: Whisper, audio: torch.Tensor,
                                   max_len: Optional[int] = None
                                   ) -> Tuple[torch.Tensor, int]:
    """`transcribe_features`'s tokens and the decode steps it ran."""
    cfg = model.cfg
    audio = pad_or_trim(audio, audio_window_samples(cfg))
    mel = log_mel_spectrogram(audio, n_mels=cfg.n_mels)
    return greedy_decode_with_steps(model, mel, max_len=max_len)
