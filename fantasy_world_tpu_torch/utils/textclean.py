"""Prompt text cleaning with reference-prompter semantics (the port's copy
of ``fantasy_world_tpu/utils/textclean.py``; pure Python).

The reference tokenizes prompts through ``whitespace_clean(basic_clean(text))``
where ``basic_clean = ftfy.fix_text(text); html.unescape(html.unescape(text))``
(diffsynth_wan21/prompters/wan_prompter.py:11-20,76; identical in wan22).
A prompt with mojibake or HTML entities therefore tokenizes differently from
its raw form, and every downstream activation diverges.

ftfy is not a baked-in dependency here, so this module implements the subset
of ``ftfy.fix_text`` default behavior that is reachable from prompt text,
natively:

  * fix_encoding       -- iterative mojibake repair (UTF-8 read as
                          cp1252/latin-1), the core of ftfy. Implemented with
                          the "sloppy cp1252" byte map and a strict-UTF-8
                          re-decode acceptance test per whitespace-delimited
                          chunk (ASCII space can never be a UTF-8
                          continuation byte, so chunking is lossless).
  * restore_byte_a0    -- a space where a 0xA0 continuation byte was
                          squashed ('VoilÃ !' -> 'Voilà!'; 'Ã  la mode'
                          with two spaces -> 'à la mode', and the fully
                          collapsed 'Ã la mode' -> the lossy 'àla mode',
                          since the space IS the destroyed byte): the
                          space is speculatively restored to \xa0, gated
                          on word context (an uppercase letter before the
                          lead char marks genuine all-caps text like
                          'MAÇÃ MADURA', which stays untouched -- the
                          same carve-out ftfy's badness heuristic makes).
  * replace_lossy_sequences -- a mojibake lead char followed by U+FFFD
                          replacement characters (the continuation bytes
                          were destroyed) collapses to one U+FFFD, as ftfy
                          does when a sequence is unrecoverable.
  * fix_surrogates     -- UTF-16 surrogate pairs leaked as codepoints are
                          combined; lone surrogates become U+FFFD.
  * unescape_html auto -- entities unescaped when the text isn't HTML markup.
  * remove_terminal_escapes, fix_latin_ligatures, fix_character_width
    (fullwidth ASCII narrowed AND halfwidth katakana widened via per-char
    NFKC, dakuten recomposed by the final NFC), uncurl_quotes,
    fix_line_breaks, remove_control_chars, NFC normalization
    -- direct translations of the corresponding ftfy fixers.

Known divergence from full ftfy (documented, not reachable from sane
prompts): ftfy gates its lossy/a0 fixers on a trained "badness" heuristic;
here the gate is the stricter structural test (the repair must make the
chunk decode as valid UTF-8), and '?'-marker lossy sequences (ftfy's
optional second marker) are left alone because '?' is overwhelmingly a real
question mark in prompt text.
"""
from __future__ import annotations

import html
import re
import unicodedata

# cp1252's 27 printable remappings of the C1 range; every other codepoint
# <= 0xFF maps to its own byte value ("sloppy" cp1252, so that literal C1
# control characters survive the round trip the way ftfy's sloppy codec
# keeps them).
_CP1252_SPECIALS = {
    "€": 0x80, "‚": 0x82, "ƒ": 0x83, "„": 0x84,
    "…": 0x85, "†": 0x86, "‡": 0x87, "ˆ": 0x88,
    "‰": 0x89, "Š": 0x8A, "‹": 0x8B, "Œ": 0x8C,
    "Ž": 0x8E, "‘": 0x91, "’": 0x92, "“": 0x93,
    "”": 0x94, "•": 0x95, "–": 0x96, "—": 0x97,
    "˜": 0x98, "™": 0x99, "š": 0x9A, "›": 0x9B,
    "œ": 0x9C, "ž": 0x9E, "Ÿ": 0x9F,
}


def _encode_sloppy_cp1252(text: str):
    """Bytes the text would have been, had it been UTF-8 misread as cp1252.
    None if any character has no cp1252/latin-1 byte (then it can't be
    mojibake of that kind)."""
    out = bytearray()
    for ch in text:
        cp = ord(ch)
        if cp <= 0xFF:
            out.append(cp)
        else:
            b = _CP1252_SPECIALS.get(ch)
            if b is None:
                return None
            out.append(b)
    return bytes(out)


def _fix_chunk_once(chunk: str):
    """One mojibake-repair pass on a whitespace-free chunk. Acceptance test:
    the sloppy-cp1252 bytes must decode as STRICT UTF-8 and actually consume
    multi-byte sequences (len shrinks) -- plain accented text fails the
    strict decode, so 'café'-style genuine Latin-1 is never mangled."""
    if not any(ord(c) > 0x7F for c in chunk):
        return chunk, False
    raw = _encode_sloppy_cp1252(chunk)
    if raw is None:
        return chunk, False
    try:
        fixed = raw.decode("utf-8")
    except UnicodeDecodeError:
        return chunk, False
    if len(fixed) >= len(chunk):
        return chunk, False
    return fixed, True


# mojibake "lead" characters: what a UTF-8 lead byte (0xC2-0xF4) looks like
# after a cp1252/latin-1 misread
_BYTE_TO_CHAR = {b: ch for ch, b in _CP1252_SPECIALS.items()}
_LEAD_CHARS = "".join(_BYTE_TO_CHAR.get(b, chr(b))
                      for b in range(0xC2, 0xF5))
# a lead char followed by a space that may have been a squashed \xa0 byte.
# Restricted to the C2/C3 leads (-> U+00A0 nbsp and the 'Ã ' = 'à' class,
# the cases that occur in real web text): ftfy attempts every lead byte but
# gates acceptance on its global badness heuristic; without that heuristic
# the wider net mangles genuine text ('Å 2' -> 'Š2', caught by
# test_fix_encoding_leaves_genuine_text_alone)
_A0_RE = re.compile("([Â-Ã]) ")
# a lead char, up to two surviving continuation-byte chars, then U+FFFD(s)
# where the remaining continuation bytes were destroyed
_CONT_CHARS = "".join(_BYTE_TO_CHAR.get(b, chr(b))
                      for b in range(0x80, 0xC0))
_LOSSY_RE = re.compile(f"[{re.escape(_LEAD_CHARS)}]"
                       f"[{re.escape(_CONT_CHARS)}�]{{0,2}}�{{1,3}}")


def restore_byte_a0(text: str) -> str:
    """ftfy.fixes.restore_byte_a0: a prior process turned \\xa0 (no-break
    space, a common UTF-8 continuation byte) into a plain space, breaking
    the mojibake pattern ('Ã  la mode', two spaces, for 'à la mode'; the
    fully collapsed single-space form recovers lossily as 'àla mode').
    Speculatively put the byte back wherever that single change lets the
    strict-UTF-8 repair succeed; otherwise leave the text untouched."""

    def try_restore(m):
        # A lead char + \xa0 is ALWAYS a valid 2-byte UTF-8 sequence, so the
        # structural acceptance test below is vacuous for this fixer; a
        # context gate stands in for ftfy's badness heuristic instead. An
        # uppercase letter immediately before 'Ã' means an all-caps word
        # ending in Ã -- genuine text in Portuguese (MAÇÃ, IRMÃ, MANHÃ,
        # ALEMÃ), which ftfy's heuristic deliberately declines to "fix".
        # 'Â' has no such carve-out: no real word ends in 'Â '+space, while
        # 'wordÂ ' (an nbsp whose C2 lead survived) is the single most
        # common mojibake shape -- it repairs regardless of case context,
        # as do 'Ã la mode' / 'VoilÃ !' style lowercase contexts.
        i = m.start()
        if i > 0 and m.group(1) == "Ã" and text[i - 1].isupper():
            return m.group(0)
        # a LITERAL \xa0 in the word holding the lead char means this
        # region's bytes were demonstrably not squashed -- leave it to the
        # plain chunk repair. Gated per word, not per prompt: ftfy applies
        # the fixer per mojibake sequence, so a genuine nbsp in 'café\xa0bar'
        # must not stop 'VoilÃ le monde' elsewhere from repairing.
        j = i
        while j > 0 and text[j - 1] not in " \t\n\r\f\v":
            j -= 1
        if "\xa0" in text[j:i]:
            return m.group(0)
        fixed, changed = _fix_chunk_once(m.group(1) + "\xa0")
        return fixed if changed else m.group(0)

    return _A0_RE.sub(try_restore, text)


def replace_lossy_sequences(chunk: str) -> str:
    """ftfy.fixes.replace_lossy_sequences: a mojibake lead char whose
    continuation bytes were already destroyed (U+FFFD markers) can never
    be repaired -- collapse the whole sequence to one U+FFFD. Applied only
    to chunks still holding a replacement character after repair."""
    return _LOSSY_RE.sub("�", chunk)


def fix_encoding(text: str, max_passes: int = 4) -> str:
    """Repair UTF-8-misread-as-cp1252 mojibake, including multiply-encoded
    text (each pass unwraps one layer, e.g. 'doesnÃ¢a€...'
    -> 'doesna€™t' -> 'doesn’t')."""
    text = restore_byte_a0(text)       # gates itself per word on literal \xa0
    parts = re.split(r"([ \t\n\r\f\v]+)", text)
    out = []
    for part in parts:
        for _ in range(max_passes):
            part, changed = _fix_chunk_once(part)
            if not changed:
                break
        if "�" in part:
            part = replace_lossy_sequences(part)
        out.append(part)
    return "".join(out)


_ANSI_RE = re.compile(r"\033\[((?:\d|;)*)([a-zA-Z])")

_LIGATURES = {
    ord("Ĳ"): "IJ", ord("ĳ"): "ij",
    ord("ﬀ"): "ff", ord("ﬁ"): "fi", ord("ﬂ"): "fl",
    ord("ﬃ"): "ffi", ord("ﬄ"): "ffl", ord("ﬅ"): "st",
    ord("ﬆ"): "st",
}

_UNCURL = {
    ord("‘"): "'", ord("’"): "'", ord("‚"): "'",
    ord("‛"): "'",
    ord("“"): '"', ord("”"): '"', ord("„"): '"',
    ord("‟"): '"',
}

# Fullwidth ASCII block (U+FF01..U+FF5E) -> ASCII; the common fullwidth
# currency/sign block entries NFKC also folds.
_WIDTH = {cp: chr(cp - 0xFEE0) for cp in range(0xFF01, 0xFF5F)}
_WIDTH.update({0xFFE0: "¢", 0xFFE1: "£", 0xFFE2: "¬",
               0xFFE3: "¯", 0xFFE4: "¦", 0xFFE5: "¥",
               0xFFE6: "₩", 0x3000: " "})
# halfwidth katakana / jamo / punctuation (U+FF61..U+FFDC, U+FFE8..U+FFEE)
# widened through per-char NFKC, exactly ftfy's fix_character_width 'H'
# side; dakuten/handakuten land as combining marks the final NFC composes
# (ｶﾞ -> ガ)
for _cp in list(range(0xFF61, 0xFFDD)) + list(range(0xFFE8, 0xFFEF)):
    _n = unicodedata.normalize("NFKC", chr(_cp))
    if _n != chr(_cp):
        _WIDTH[_cp] = _n
del _cp, _n

_LINE_BREAKS = {ord("\r"): "\n", 0x2028: "\n", 0x2029: "\n", 0x0085: "\n"}

_CONTROL_RE = re.compile(r"[\x00-\x08\x0b\x0c\x0e-\x1f\x7f-\x9f﻿]")

_ENTITY_RE = re.compile(r"&(#\d+|#[xX][0-9a-fA-F]+|[a-zA-Z][a-zA-Z0-9]*);")


def fix_surrogates(text: str) -> str:
    """ftfy.fixes.fix_surrogates: UTF-16 surrogate codepoints leaked into
    the string (e.g. a JSON decoder that didn't join pairs) -- join proper
    pairs into the character they encode, replace lone surrogates with
    U+FFFD."""
    if not any("\ud800" <= c <= "\udfff" for c in text):
        return text
    out, i = [], 0
    while i < len(text):
        c = ord(text[i])
        if 0xD800 <= c <= 0xDBFF and i + 1 < len(text) \
                and 0xDC00 <= ord(text[i + 1]) <= 0xDFFF:
            out.append(chr(0x10000 + ((c - 0xD800) << 10)
                           + (ord(text[i + 1]) - 0xDC00)))
            i += 2
        elif 0xD800 <= c <= 0xDFFF:
            out.append("�")
            i += 1
        else:
            out.append(text[i])
            i += 1
    return "".join(out)


def fix_text(text: str) -> str:
    """Native subset of ftfy.fix_text() with default config, in ftfy's fixer
    order: unescape-html(auto) -> terminal escapes -> mojibake (incl. byte-
    a0 restore + lossy-sequence collapse) -> ligatures -> width (both
    directions) -> uncurl quotes -> line breaks -> surrogates -> control
    chars -> NFC."""
    if "<" not in text and _ENTITY_RE.search(text):
        text = html.unescape(text)
    text = _ANSI_RE.sub("", text)
    text = fix_encoding(text)
    text = text.translate(_LIGATURES)
    text = text.translate(_WIDTH)
    text = text.translate(_UNCURL)
    text = text.replace("\r\n", "\n").translate(_LINE_BREAKS)
    text = fix_surrogates(text)
    text = _CONTROL_RE.sub("", text)
    return unicodedata.normalize("NFC", text)


def basic_clean(text: str) -> str:
    """wan_prompter.py:11-14: fix_text then a DOUBLE html.unescape (handles
    double-escaped entities like '&amp;amp;'), then strip."""
    text = fix_text(text)
    text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text: str) -> str:
    """wan_prompter.py:17-20: collapse all whitespace runs to single
    spaces."""
    return re.sub(r"\s+", " ", text).strip()


def clean_prompt(text: str) -> str:
    """The exact preprocessing the reference tokenizer applies with
    clean='whitespace' (wan_prompter.py:74-76, 95)."""
    return whitespace_clean(basic_clean(text))
