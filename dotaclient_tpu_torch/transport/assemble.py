"""Shard-side row assembly for `--broker.assemble` (own copy of
dotaclient_tpu/transport/assemble.py; in-network batch assembly).

A fabric shard with assembly armed packs each admitted frame ONCE into
the learner's single-buffer row layout (parallel/fused_io.py RowLayout)
and serves consumers DTB1 blocks of pre-packed rows; the learner host
then lands rows with a row concat. The row encoder is the learner's own
pack over views of the same RowLayout: a one-row `native.PackPlan`
prebuilt over the row buffer, or `fill_rollouts`, so shard-assembled and
learner-packed bytes are the same bytes.

A shard imports this module only once a GET_BLOCK arms its assembler
(transport/tcp.py), so a shard that never arms assembly keeps its import
surface; RowLayout and the packer load inside RowAssembler.
"""

from __future__ import annotations

from dotaclient_tpu_torch.ops.batch import tree_flatten, tree_unflatten, zeros_train_batch
from dotaclient_tpu_torch.transport.fabric import peek_fabric, strip_fabric
from dotaclient_tpu_torch.transport.serialize import (
    _ROLLOUT_MAGIC2,
    _ROLLOUT_MAGIC3,
    AssembledRow,
    BlockSpec,
    check_dtr3_dtype_map,
    peek_rollout_trace,
    strip_rollout_trace,
)


class RowAssembler:
    """Packs one wire frame at a time into RowLayout row bytes.

    Single-threaded: the broker's event loop owns it (one per armed
    shard), packing at admission and for the pre-spec backlog at block
    build. It holds a one-row buffer and a pristine copy of it (zeros and
    the template's NOOP action-mask floor); each pack starts from the
    pristine bytes, so a short rollout leaves no residue of a longer one,
    as zeros_train_batch guarantees the classic path."""

    def __init__(self, seq_len: int, lstm_hidden: int, with_aux: bool, obs_bf16: bool, use_native: bool = True):
        import numpy as np

        from dotaclient_tpu_torch.parallel.fused_io import RowLayout, _host_array
        from dotaclient_tpu_torch.transport.serialize import bf16_tensor

        self._np = np
        tmpl = zeros_train_batch(1, seq_len, lstm_hidden, with_aux)
        if obs_bf16:
            tmpl = tmpl._replace(obs=tmpl.obs._replace(**{
                f: bf16_tensor(np.zeros(v.shape, np.uint16))
                for f, v in tmpl.obs._asdict().items() if v.dtype == np.float32
            }))
        tmpl_leaves, structure = tree_flatten(tmpl)
        layout = RowLayout([(tuple(leaf.shape), leaf.dtype) for leaf in tmpl_leaves])
        self.layout = layout
        self.spec = BlockSpec(seq_len, lstm_hidden, with_aux, obs_bf16, layout.row_bytes, layout.layout_crc)
        self._buf = np.zeros((1, layout.row_bytes), np.uint8)
        self._batch = tree_unflatten(structure, layout.views_into(self._buf, 1))
        for view, leaf in zip(tree_flatten(self._batch)[0], tmpl_leaves):
            view[...] = _host_array(leaf)
        self._pristine = self._buf.copy()
        self._plan = None
        if use_native:
            from dotaclient_tpu_torch import native

            self._native = native
            self._lib = native.load_packer()
            self._plan = native.PackPlan(self._lib, self._batch, 1, seq_len, lstm_hidden, with_aux, obs_bf16, 0, 1)

    @property
    def native_active(self) -> bool:
        return self._plan is not None

    def assemble(self, frame: bytes, priority: float = 0.0) -> AssembledRow:
        """One admitted broker frame (FAB1 envelope included when the
        producer sent one) → its AssembledRow. Raises ValueError naming the
        quarantine reason ("dtype_map", "parse", "layout") for a frame the
        classic ingest would reject too; the caller counts it and never
        ships it."""
        boot = epoch = seq = 0
        env = peek_fabric(frame)
        if env is not None:
            _key, boot, epoch, seq = env
            frame = strip_fabric(frame)
        trace_id, birth = 0, 0.0
        if frame[:4] == _ROLLOUT_MAGIC2:
            trace_id, birth = peek_rollout_trace(frame)
            frame = strip_rollout_trace(frame)
        if frame[:4] == _ROLLOUT_MAGIC3:
            reason = check_dtr3_dtype_map(frame)
            if reason is not None:
                raise ValueError(reason)
            trace_id, birth = peek_rollout_trace(frame)
        self._np.copyto(self._buf, self._pristine)
        spec = self.spec
        if self._plan is not None:
            hdr = self._native.frame_header(self._lib, frame)
            if hdr is None:
                raise ValueError("parse")
            version, L, H, _flags, actor_id, ep_ret, last_done = hdr
            if L > spec.seq_len or H != spec.lstm_hidden:
                raise ValueError("layout")
            self._plan.pack([frame])
        else:
            from dotaclient_tpu_torch.runtime.staging import fill_rollouts
            from dotaclient_tpu_torch.transport.serialize import deserialize_rollout

            try:
                r = deserialize_rollout(frame)
            except ValueError:
                raise ValueError("parse")
            L = r.length
            if L > spec.seq_len or r.initial_state[0].shape[0] != spec.lstm_hidden:
                raise ValueError("layout")
            fill_rollouts(self._batch, [r], spec.seq_len)
            version, actor_id, ep_ret = r.version, r.actor_id, float(r.episode_return)
            last_done = float(r.dones[L - 1]) if L else 0.0
        return AssembledRow(
            payload=self._buf.tobytes(),
            version=int(version),
            actor_id=int(actor_id),
            episode_return=float(ep_ret),
            trace_id=int(trace_id),
            birth_time=float(birth),
            priority=float(priority),
            boot=int(boot),
            epoch=int(epoch),
            seq=int(seq),
            last_done=float(last_done) > 0.0,
        )
