"""MQ arithmetic encoder (ISO 15444-1 Annex C).

Behavior parity: /root/reference/libavcodec/mqcenc.c (byteout/renorme/
setbits/ff_mqc_initenc/ff_mqc_encode/ff_mqc_flush_to). Used by the T.800
tier-1 encoder; the decoder counterpart lives in ops/ebcot.MQDecoder.
"""

from __future__ import annotations

from ffmpeg_ht_tpu_torch.ops import tables as tb


class MQEncoder:
    """MQ encoder writing into an internal byte buffer.

    The buffer carries one leading sentinel zero byte playing the role of
    the reference's ``bp = data - 1`` pre-byte (mqcenc.c:71-78: cblk->data[0]
    is zeroed and encoding starts at cblk->data + 1).
    """

    __slots__ = ("cx_states", "a", "c", "ct", "buf", "bp")

    def __init__(self):
        self.cx_states = tb.mq_initial_cx_states()
        self.a = 0x8000
        self.c = 0
        self.buf = bytearray(1)  # sentinel == *(bp-1) == 0
        self.bp = 0              # index of the sentinel
        self.ct = 12             # sentinel is 0, never 0xff

    # --- internal helpers operating on an explicit (buf, bp) state ---

    @staticmethod
    def _byteout(st) -> None:
        while True:
            if st["buf"][st["bp"]] == 0xFF:
                st["bp"] += 1
                MQEncoder._put(st, st["c"] >> 20)
                st["c"] &= 0xFFFFF
                st["ct"] = 7
                return
            elif st["c"] & 0x8000000:
                st["buf"][st["bp"]] += 1
                st["c"] &= 0x7FFFFFF
                continue
            else:
                st["bp"] += 1
                MQEncoder._put(st, st["c"] >> 19)
                st["c"] &= 0x7FFFF
                st["ct"] = 8
                return

    @staticmethod
    def _put(st, val: int) -> None:
        if st["bp"] == len(st["buf"]):
            st["buf"].append(0)
        st["buf"][st["bp"]] = val & 0xFF

    def _state(self) -> dict:
        return {"buf": self.buf, "bp": self.bp, "c": self.c,
                "a": self.a, "ct": self.ct}

    def _restore(self, st) -> None:
        self.bp = st["bp"]
        self.c = st["c"]
        self.a = st["a"]
        self.ct = st["ct"]

    def _renorme(self, st) -> None:
        while True:
            st["a"] = (st["a"] + st["a"]) & 0xFFFFFFFF
            st["c"] = (st["c"] + st["c"]) & 0xFFFFFFFF
            st["ct"] -= 1
            if st["ct"] == 0:
                self._byteout(st)
            if st["a"] & 0x8000:
                break

    def encode(self, cx: int, d: int) -> None:
        """Code decision d in context cx (mqcenc.c:81-103)."""
        st = self._state()
        state = int(self.cx_states[cx])
        qe = int(tb.MQ_QE[state])
        st["a"] -= qe
        if (state & 1) == d:
            if not (st["a"] & 0x8000):
                if st["a"] < qe:
                    st["a"] = qe
                else:
                    st["c"] += qe
                self.cx_states[cx] = tb.MQ_NMPS[state]
                self._renorme(st)
            else:
                st["c"] += qe
        else:
            if st["a"] < qe:
                st["c"] += qe
            else:
                st["a"] = qe
            self.cx_states[cx] = tb.MQ_NLPS[state]
            self._renorme(st)
        self._restore(st)

    def flush_to(self) -> tuple:
        """Non-destructive flush (ff_mqc_flush_to, mqcenc.c:105-137).

        Returns (rate, flushed): `rate` counts the bytes committed to the
        main buffer past the sentinel; `flushed` is the tail that a final
        flush would append (stored per pass for layer assembly).
        """
        dst = bytearray([self.buf[self.bp]])
        st = {"buf": dst, "bp": 0, "c": self.c, "a": self.a, "ct": self.ct}
        # mqc_flush on the clone
        tmp = st["c"] + st["a"]
        st["c"] |= 0xFFFF
        if st["c"] >= tmp:
            st["c"] -= 0x8000
        st["c"] = (st["c"] << st["ct"]) & 0xFFFFFFFF
        self._byteout(st)
        st["c"] = (st["c"] << st["ct"]) & 0xFFFFFFFF
        self._byteout(st)
        if st["bp"] < len(dst) and dst[st["bp"]] != 0xFF:
            st["bp"] += 1
        dst_len = st["bp"]
        flushed = bytes(dst[:dst_len])
        committed = self.bp - 1  # bytes past the sentinel (bpstart == 1)
        if committed < 0:
            # nothing committed yet: first flushed byte duplicates the
            # zero sentinel (mqcenc.c:126-133)
            assert committed == -1 and dst_len > 0 and flushed[0] == 0
            return 0, flushed[1:]
        return committed, flushed

    def committed_bytes(self) -> bytes:
        """Fully committed bytes (sentinel and in-progress byte excluded)."""
        return bytes(self.buf[1:self.bp]) if self.bp >= 1 else b""
