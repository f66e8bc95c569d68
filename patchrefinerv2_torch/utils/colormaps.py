"""The colormaps that the depth images use (the Tester's ``Spectral``,
``magma_r`` and ``gray_r``, the feature maps' ``magma`` and ``Spectral_r``,
the training panels' ``turbo_r``), as lookup
tables: for each name, matplotlib's 256 colors as RGBA bytes, then its under, over and bad
colors (matplotlib's ``(Colormap._lut * 255).astype(np.uint8)``, zlib and
base64). ``utils/color.colorize`` indexes them as matplotlib's
``Colormap.__call__(..., bytes=True)`` does, so the port needs no
matplotlib; ``tests/test_torch_general_cli.py`` holds each table to
matplotlib's where it is installed."""

from __future__ import annotations

import base64
import functools
import zlib

import numpy as np

_TABLES = {
    "Spectral": (
        "eNoV03lMFnQAxvFaa2utrbW11tbaWmtrba21zNJMM3hfXl5eXogIUUSEMTwiyWGG5lGoozGmZh5xHy8/7vt4uSWG"
        "eCGiqBAiccl9yPkevO/7+32jZ/vs+fv540l/3o3MF9wwveiOeMmd3Jc15L+iofBVLSWvaSl73YOKNzyoelOH+S0d"
        "tW970vCOJ03v6ml+T0/L+160fuBF24cGbnxk4PbH3txZ583d9UbubTDS9YUPD7/0oXuLDz1bfeh1M/JYY6TPw5sn"
        "nt706w0MGAwMGg0M+Xox7OfFiL+e0QA9Y9s8Gd/uyUSQjqlgHdMhHsyEejAbpmUuXMt8hIaFvRoW97uzFOnOyoE1"
        "P2pYidZi+ckDS4wOy1FPrMe9sJ40YI31xnbaiC3OB1u8L/YEP+znvsX+hz+rF79j9XIAjsRtOJK340jbgTMjCKdp"
        "J86cYFx5IbgKd+MqDkWWhiHLw5GVEcjqPciafci675ENkcimA8jmKGTLQWRrNLLtEPLGYeStGGT7EWTHL8jO48j7"
        "J5APfkU+ikX2nEL2nkH2xSH7f0cOxKOGElDDZ1Ej51FPL6BGL6LGL6Mm/kJNJqGmUlDTaajZDNRcFupZNmo+B7WY"
        "h1oqQC0XoVZKUJYylK0CZa9CrZpRjlqUsx4lG1Hq6ppmpGrCpRpxynocso5VVw12lxmbqwqrsxKLs5wVRynLjhKW"
        "HEUsrhaysJrPvD2PZ/Yc5uyCWZuJGVsW09YMpqzpTFpTmbCkMG5JWpPI05VEhpcTGVxKon8xib6FZHrnk+l+lsLD"
        "uRS6ZlPpnEmlY21T+1QaNyfTuT6RzrXxDFrGMmgey6RpNJOGp5nUjmRhHs6iashE+aCJ0oFsiv/NpqBfkPtEIPoE"
        "WY8F6b2C1H8EST2CK92CS48EFx4IznUJEu4L4u8J4joFp+8KYjsEJ+8IjrULjtwW/HxLcOim4OANQdR1QWSbYN81"
        "wZ7WHML/ziHsai67G/PYVZfPzpoCdlQXElhZREBZMf4lJfgVleKbX4YxtxyDqEBvqkSXUYU2rRr3FDNfJ5n56koN"
        "my/VsunPOjaer+fzsw2sT2hkXXwTn8Q18emZRj471cCG3+rZeKKOTcdq2Xy0hi0xZrYersYtuhLNwQq0UeXofihD"
        "v78Uw94SvCOK8Qkv4pvQQvxCCvAPzicgKI/AwFy2B+QQ5C8I9ssmxNdE+tr//+/n1vIfKVrshQ=="
    ),
    "Spectral_r": (
        "eNoVk3lMFXQAx2utrbW21tZaW2trra21tdYySzPNeBePx3tERCgS4phX5jHM0DwKdTTG1Mwjkfvxe9yP+3FLThEv"
        "RPEgRBJR7hvk3e/3+4Sf7bPP398/vrFhVmLC84iOEKyKtBEVlU9kdAERMYWExxbxTVwxlvgSQteXYtpox7i5DMNP"
        "5ei2VaDdUUlQQhUrd9WwItHB8j21LNtbx9L99Sz5vYHPDjby6eEmPkluZlFKM4tTm/j8SCNLjzWw7K96lp+s46vT"
        "tXyd5kCT7kCXWYMhuxqjtQqTqMScX0FYYTnhJWVE2O1ElpcSVVXC6ppi1tQW8UN9IWubClh3Lp/4f2xsuGBj00XB"
        "llbBtkuCHW2CnZcFv1wR7L4q2HtNcOC6IKldcOiGILlDkHJTkHpLcLRTcPy24ORdwel7grQuQca/gqxuQe59gegR"
        "5D8QFPUKSv/Lo+xhHhV9VqofWXH051L3OJfGJzk0D+TQMpjD+cFsLg5lc2k4i8sjWVwbzaR9LJOO8Qw6JzK4M5nO"
        "val0uqfP0jNzlt7ZNPrm0uh/eoYn82cYcj4zjWFnOiOuDEZdWYy5shl35zLhtjLpEUx5bEx7CpjxFjLrLWbOV8JT"
        "n515XxlOfwUufxXuQDWegANvoBafrMcvGwioJqRqRqmWBc+hZBPK34Dy1aG8DpSnGuWuRDnLUfN21NMS1FwRarYA"
        "NW1DTeWhJnNRE9mohU1qNB01koYa/hs1dAo1cAL15Djq8TFU/xHUo1TkwxRk7x/InmRk92Fk10Hk3STk7d+Qt/Yj"
        "O/Yh239FXtuNvJKIbNuFbN2JvJCAPL8D2bId2bwV2bgFWf8jsnYTsmYDsmo9siIeWbaOQGkcgeK1BApi8dti8FvX"
        "4M+Oxpe5Gt/ZVfjOROE9FYn3xHd4/ozAc/RbPKnhuFPCcCdbcB8y40oKxXXAhGtfCM49wTgTDTh/1jOfoGN+u5b5"
        "rRrmtmiY3axhZqOW6fVaJuN1TKzTMR6nZyxWz2iMgeFoA0Orghn8PpiBSCOPI4z0h4fwKCyEPrOJhyYTvUYTD4JD"
        "6dGHcl9rpjvITNdKC/dWWLjzpYXOLyzcXGLmxmIz1xeFcvXjUNo+MtH6oYkLH4Rw/v0QWt4z0vyukcZ3gql7OxjH"
        "Wwaq3zRQ+Yae8tf12F/TUfyqjsJXtOS/rEW8pMH6ooacF4LIej6I2IX/P+tzC/wPvNfshw=="
    ),
    "gray_r": (
        "eNotxgks0A0AQHE1ORaSoYwic44kixg6rKiRazma23RYp1aO5YiGUnItd87lDKVVSoVaqUhhznIUipSjSwe99v33"
        "ve23PYC/f/+ysLDA/Pw8f/784ffv3/z69YufP38yNzfHjx8/+P79O9++fePr1698+fKF2dlZZmZmmJ6eZmpqis+f"
        "P/Pp0ycmJyf5+PEjExMTjI+P8+HDB96/f8/Y2Bijo6OMjIzw7t073r59y/DwMENDQwwODjIwMMCbN294/fo1/f39"
        "9PX10dvbS09PD93d3XR1ddHZ2Sno6Oigvb2dV69e8fLlS9ra2njx4gWtra20tLTw/Plznj17xtOnT2lububJkyc8"
        "fvyYR48eCR4+fEhTUxONjY00NDTw4MED7t+/z71796ivr+fu3bvcuXOHuro6bt++za1bt7h58yY3btwQ1NbWcv36"
        "da5du0ZNTQ3V1dVUVVVx9epVKisrqaiooLy8nLKyMkpLSykpKeHKlSsUFxcLioqKKCwspKCggPz8fPLy8rh8+TK5"
        "ubnk5OSQnZ1NVlYWmZmZZGRkkJ6ezqVLl0hLSxOkpqaSkpJCcnIySUlJXLx4kcTERC5cuMD58+dJSEjg3LlznD17"
        "lvj4eOLi4oiNjeXMmTOCmJgYoqOjOX36NFFRUURGRhIREUF4eDinTp0iLCxMEBoaSkhICMHBwZw8eZITJ05w/Phx"
        "goKCBMeOHePo0aMcOXKEw4cPc+jQIQ4ePEhgYKDgwIED7N+/n3379rF3714CAgLw9/fHz89P4Ovri4+PD97e3nh5"
        "eeHp6YmHhwd79uwRuLu74+bmhqurKy4uLuzevRtnZ2ecnJwEjo6OODg4YG9vz65du7Czs8PW1padO3cKduzYgY2N"
        "DdbW1mzfvp1t27ZhZWXF1q1bBVu2bGHz5s1s2rQJS0tLLCwsMDc3x8zMDFNTU8HGjRsxMTHB2NiYDRs2YGRkxPr1"
        "6zE0NBSsW7cOAwMD1q5di76+Pnp6eujq6qKjoyPQ1tZGS0sLTU1NNDQ0UFdXZ82aNaipqQlUVVVZvXo1q1atQkVF"
        "BWVlZZSUlFi5cqVgxYoVKCoqoqCggLy8PHJycixfvhxZWVnBsmXLkJGRQVpaGikpKZYuXYqkpCQSEhICcXFxxMTE"
        "WLJkCaKioixevJhFixYhIiIi+K//X+QfaEaCKA=="
    ),
    "magma": (
        "eNot0+lTVWUAgPGLbLKee0BERcVQiRAFRVKUXHCXKKJI7XLhArIj+353XFJTM4whTWNIIzOGZBgyhjTHyhbHynKs"
        "HK2sNMeMNDODe855ej/04TfPX/DodO7odB6CF246b9zcfAQ/Ro0KECTc3WU83IPx8AjB0yMUL8/xeHuGMdprEj7e"
        "4fh6R+A3ehr+PpEE+EYR6BuN5BeD3j8W2X82QQHxjAlIICRwPmMDFxAqJTFOWswE/VLC9MuZqF/JZP0awuUUpsip"
        "RMhpTJXTmS5nECmvI0reQLScyQw5i5l6E7H6XOL0+czRFzJXX0SCVMI8qYxEqZyFUgVJUhWLpGqWSDUkS7Usk+pY"
        "IdWzSmpgtb6RtfomUoRUuZknZTNpQWbSgyw8HWwhI9jKujFW1ofYeE4wjLVhDLWRFWrHNM5OjpA33k7+BAcFQlGY"
        "g+KJDkqFskkOyic7qRCqwp3UCLVTnNQ/5KRBaIpw0ixYpjqxTXNiF5zTnbQIWyKdbBWef9jJjignO4VdjzjYLbwY"
        "7eAloXWGg5eFthgH7TF29s+0c0A4OMvOa7NsdMTa6BQOx9k4Emela7aVN4W35lh4O95Cd7yZnrlmjgu9Cc30Cf2P"
        "NvGu8N68RgaEwfkNnExs4FRiPacX1HFG+HBhLR8n1XI2qYZPH6vm80XVnFtUxfnFlXyxpJKvllZwIbmcb5I3cXHZ"
        "Ji4tL+PbFaV8v7KEy6uKubK6mKtrivhhbSE/pRRw7fECfk7N59cnNnI9LY8bT+XyW3ouN5/J4VaGid+fNXF7fTZ/"
        "bMhmyJDFkNHIn1lG7piM3M3J5K+8TO7lC4UG/i4ycL9EKDPwT7lQaeBBlVCTyb91QkMmw02C2ciw1ciIPYsRh9CS"
        "jWuLCdc2YXsOrp25KLvyUPYIezeitOaj7CtAbStEbS9C3V+M+moJ6qFS1I4y1M5y1NcrUI9UonVVoR2tQTtWi9Zd"
        "h9ZTj/ZOI1pvE1qfGa3fgnbCijZgRxt0oL3fgnZqM9rprWhntqF9tB3t7A60T15A+2w32rk9qOf3on7ZinphH+rX"
        "bagX21EvvYL63QHUywdRrxxCvdqB+mMn6rXDKL+8gXK9C+XGUZSbx1BudaPc7kEZOo5ypxflbh/KvX6U+ydwPRjA"
        "NTyIa+QkLuUD8b37/9Xp/gPfH2Jg"
    ),
    "magma_r": (
        "eNoV04lTVWUAhnGQTdZzD4ioqBgqEaKgSIoSKu4SRRSp3cvlArIj+353XFJTM4whTWNIIzOGZBgyhjTHyhbHynKs"
        "HK2sNMfMNDODe855+npnfvP+BY9L+QDXyAlcw0O4Hgyi3D+Ocm8A5W4/yp0+lNvHUG71otzsQblxFOX6EZRr3Si/"
        "vIF69RDqj12oVzpRLx9EvXQA9bv9qBdfQb3Qgfp1O+r5vahftqGe24N2djfaZ7vQPnkB7cx2tI+2oZ3einZqC9rJ"
        "TWjvt6INOdAG7WjHrWgDFrR+M1pfM9o7TWi9DWg99WhH69CO1KJ1V6MerkJ9vRK1qwK1sxz1YBnqq6Wo+0pQO4pR"
        "24tQ9haitBWg7NmAsjsfZWc+rh15uLbl4tpqwrXZxEhrDiMOIyN2I8PWbIbNQrOBfxuFegMPaoVqPf9UCRV67pcL"
        "pXr+LtZzr0goMPBXvoG7uQbumLL505jN7WxBb+SP9TncWpfD78+auJll4sYzufyWmcf1p/K4lpHPr09s4Of0Aq4+"
        "XshPaYX8sKaIK6uLubyqhEsrS/h+RSnfLi/j4rJyLizdyDepGzmfWsFXSyr5YnEV5xZVcTalms9Tavj0sRrOJNfy"
        "cXIdHy6s4/SCek4JJ5MaOJHUyND8RgbnNfGe8O6jzQwI/Ykt9AnH5prpFXoSzLydYOGtORbenG2lWzgcb+VQvI2u"
        "OBudwmuzbByYZWf/TDv7hI5YO+2xDl6e4aBNeCnGwYvCrkcc7BR2RDvZLjz/sJMtUU42C63TnTgF+zQnNsEy1UlL"
        "pJNmofEhJw1C3RQntRFOqoXKyU4qhPJJDsomOigRisMdFE5wUCDkj7eTO86OSTCG2ckOs6Efa+O5UBvrhLVjrGSF"
        "WHk6xEJmsIWMYDNPymbS5RbSdM2sEVbpmlgpNbJcamCpVE+qVMdiqZYUqYZkqZqFUiVJUgXzpHISpVLm6oqZoysi"
        "XldAnC6PmToTM2QjMbKBaHk9UfJapstZTJUziZQzmCKnEyGnMVm3mom6FYTrljFBt4Rx0iLCpGTGBi0gNGg+YwIT"
        "CQ5MQA6YjS4gDsk/liC/GAL9ognwjcJ/9DT8fCLx9YlgtPckfLzC8fYaj5dnGJ6eoXh6hODhITNqlCQE4u7uL/ji"
        "7uaDm5u34Cl44BL9//9uYv8BGgNiYA=="
    ),
    "turbo_r": (
        "eNoV0/lTVAUAwPHeIohnairLIYIQSkAcey/3sW9MhgZzdLAyLYeGRq00K2VkpLQYj2gwD0bDgSgmkkEZkRKSGMST"
        "kPAAIUUQuUFu2GX3vW/2/eXzF3xTZyhIs1fwlYOCgzMFMhwFjswSyJwtkDVH4PhcgVPzBE7PF8hZIJC7UCB/kUDB"
        "YoHCJQJFSwWKlQIlzgKlrgJlbgKX3QUqlgtUeiqo8lJw1VvBNR8FN1bZccvXjlo/O+4EzOCfwBncDbLnfog9jWp7"
        "mrQONOsd+Nc4k8dhM2mNcKQtypGnMbPoiJtNpzibrjfm0BM/l96EefQlzmPgrfkMrn+Z50kLGHp7ISObXmF0y2LG"
        "ti5hPHkpEylOTG5TMvWxC1M7XTHvdsPypTvTqcuZTvPAmr4C6wEvbN96Yzvkg3R0JdL3q5CO+SKd8EPO9kc+E4B8"
        "9nXkvECk/CCkgmCkwhCkcypsxWpsFzRYL2qxXtIx/bsOS7key58GzJUGpqoMTFYbGa8xMnbdyOhNI8O1RobqDAzW"
        "GxhoMNB3z0DPAz3dTXo6H+rpaNHR/kjHk1Ytj9u0tDzV8rBDQ2OnhvvdGhp61NT3qanrV3N7UMXN5yquDam4OqKi"
        "alRF5ZiainE1lyfUlE1puGjWUGLWUmzRUTSto9BqoMBq5GdbKHm2cM5KEZyRosiWYzghx3FMFsmUV3NEjidDTuCg"
        "nEi6vI598gb2yBvZLb/LTmkzO6QP+EhKJtmWwvu27WyyfsJG6y7WT3/BWsteEiz7WGNOR5w6QMxkBpEThwkd/w79"
        "eBaaseOEjJwicPg0/kM5+D7PZeVgPt4DBazoL8Sjtwj3nvMs6y7BtbMUl2dlOHf8gbK9HGXbFZxa/8LpUTVOLTU4"
        "Nd9A2XQb5YO/cb5Xj0vDXVzr7+NW18Sy2hbcbz3C4/oTPGva8ap+xqtVXfhc6WVVRT+vXR7Er2yIgNIRAkvGCD4/"
        "gapoEvVvZrS/WtD/YsXwk43QXBthORIRZ2Qis2WiTspE/yATkyUTmykRd1TCdMiGKcOK6aAF8Wsz4v5JxLRxxNRR"
        "xD3DiJ8PIn7Wj/hpD+KOLsRtHYgpbYgfPsa0tRnTlkZM793F9M4d4pJqidtwg9h11cQmVhL7Zjkx8ZeIXn2BaNM5"
        "omILiIrKIzL8RyKMJwnXZRGmOUJYyDeEBu7H6L8Xg+8u9D7b0Xklo/XcjMY9CbXrWkKUawheEkPQolBSX/z/vy+9"
        "6D+o/oeh"
    ),
}


@functools.lru_cache(maxsize=None)
def lut(name: str) -> np.ndarray:
    """(259, 4) uint8: the colormap's 256 colors, its under, over and bad colors."""
    if name not in _TABLES:
        raise NotImplementedError(f"colormap {name!r} is not in the port's tables ({sorted(_TABLES)})")
    table = np.frombuffer(zlib.decompress(base64.b64decode(_TABLES[name])), np.uint8).reshape(259, 4)
    table.flags.writeable = False
    return table


def apply(name: str, x) -> np.ndarray:
    """RGBA bytes of ``x`` (floats; 0..1 spans the colors): matplotlib's
    ``Colormap.__call__(x, bytes=True)`` for a float array, its under, over
    and bad (NaN) colors included."""
    table = lut(name)
    n = table.shape[0] - 3
    xa = np.array(x, copy=True)
    xa *= n
    xa[xa == n] = n - 1  # 1.0 is the last color, not over
    under, over, bad = xa < 0, xa >= n, np.isnan(xa)
    with np.errstate(invalid="ignore"):
        xa = xa.astype(int)
    xa[under], xa[over], xa[bad] = n, n + 1, n + 2
    return table.take(xa, axis=0, mode="clip")
