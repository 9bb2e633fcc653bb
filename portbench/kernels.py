"""The bytes a kernel of the program must move, from the shapes of its
call: each input read once and each output written once (the roofline's
count), whatever the kernel reads again."""


def decide_and_match_bytes(rows: int, slots: int, label_slots: int = 1,
                           selectors: int = 8, seg_capacity: int = 8) -> int:
    """``decide_and_match``'s fleet form with per-row status masks, as the
    fleet batch calls it: in, up and down mirrors uint32 [B, S], the status
    mask bool [B, S], the two exists flags bool [B], pair hashes uint32
    [B, L], segment ids int32 [B] and selector hashes uint32 [C]; out, the
    decision uint8 [B], the upsync flag bool [B], the match counts int32 [C]
    and the segment counts int32 [seg_capacity]. The fleet batch gives the
    kernel L = 1 and C = 8, and one section makes 8 segment slots.
    77,070,432 B at 131,072 x 64."""
    b, s = rows, slots
    read = 2 * b * s * 4 + b * s + 2 * b + b * label_slots * 4 + b * 4 + selectors * 4
    written = 2 * b + selectors * 4 + seg_capacity * 4
    return read + written
