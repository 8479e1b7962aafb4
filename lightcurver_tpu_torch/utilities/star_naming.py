"""Star labels 'a'..'z', 'aa', 'ab', ...: a copy of
``lightcurver_tpu/utilities/star_naming.py``."""

import string


def generate_star_names(n):
    """First ``n`` lowercase spreadsheet-style labels."""
    names = []
    i = 0
    while len(names) < n:
        label = ""
        k = i
        while True:
            label = string.ascii_lowercase[k % 26] + label
            k = k // 26 - 1
            if k < 0:
                break
        names.append(label)
        i += 1
    return names
